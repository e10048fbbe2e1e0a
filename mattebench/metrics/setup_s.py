"""setup_s: seconds from the process's start to the first timed step
(imports, CUDA start, the kernels' build or load, the traffic's pools, the
weights, the FLOP count, the warm-up steps)."""


def read(record: dict):
    return record["setup_s"]
