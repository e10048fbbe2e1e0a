"""CPU tests of the benchmark (``python -m pytest mattebench/tests``)."""
