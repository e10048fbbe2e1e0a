"""Command-line tools of the port: ``python -m tcvom_tpu_torch.tools.<name>``
(pred_test, pred_vmn, pred_single, calc_metric, train, make_fake_dataset)."""
