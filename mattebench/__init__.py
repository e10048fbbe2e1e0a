"""The benchmark of tcvom_tpu_torch: the 1080p matting stream on one H100
(``python3 mattebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``)."""
