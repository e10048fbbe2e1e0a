"""DIM's training step against the JAX package's, on the CPU: the checks of
test_torch_train_bn.py (losses, each module's gradient in f32 and f64,
every BatchNorm's new running statistics) on one ``train_step`` of
``vmn_dim`` (vmd driver, B = 1, S = 3, 64x64, window 3). The JAX side runs
with ``pool_by_reduce_window`` (XLA:CPU's jitted gradient of DIM's own
pool is wrong: ``test_reduce_window_pool_keeps_the_eager_gradient``).
DIM's fixture (published widths; ``conv6`` alone is 102.8 M parameters)
and IndexNet's are the two largest of the train tests, so each has its
own file and they run on different workers."""
import pytest

from test_torch_train_bn import (  # noqa: F401  (the tests run here too)
    S, _calibrate, one_thread, step_pair,
    test_train_step_batchnorm_statistics_match_jax,
    test_train_step_gradients_match_jax, test_train_step_losses_match_jax)


@pytest.fixture(scope="module")
def steps():
    return "vmn_dim", step_pair("vmn_dim", "vmd", S, _calibrate)
