"""The port's GCA training step against the JAX package's, on the CPU, in
f64 (GCA's attention amplifies f32 rounding past the tolerances in both
frameworks: test_torch_gca_model.py): one ``MattingTrainer.train_step`` of
``vmn_gca`` with the video loss stack (B = 1, S = 5) and one of the TAM
pretrain with a frozen backbone (``single`` driver, S = 3), against JAX's
``train=True, mutable=["batch_stats", "spectral"]`` gradient at 64x64,
window 3: losses, each module's gradient, every BatchNorm's running
statistics and every spectral-norm ``u`` and ``v``; the frozen backbone's
weights, statistics and vectors unchanged on both sides.

The weights are test_torch_gca_model.py's: ``u`` and ``v`` converged,
random BatchNorm affines, statistics from one pass."""
import numpy as np
import pytest

import torch

from tcvom_tpu.ops import gca_attention as JA
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models.registry import (calibrate_random_weights,
                                             converge_spectral_norms)
from test_torch_gca_model import _frames, _randomize_batchnorm_affines
from test_torch_train_bn import (module_errors, one_thread,  # noqa: F401
                                 step_pair)

FROZEN = ("encoder.", "decoder.layer1.", "decoder.layer2.", "decoder.gca.")
STATS = ("running_mean", "running_var", "weight_u", "weight_v")


def _prepare(port, cfg):
    converge_spectral_norms(port)
    _randomize_batchnorm_affines(port, 11)
    imgs, tris = (torch.from_numpy(a) for a in _frames(12))
    calibrate_random_weights(port, lambda: TFM.forward_eval(port, imgs, tris,
                                                            cfg))


@pytest.fixture(scope="module", params=["vmd", "frozen_single"])
def step(request):
    """(driver, port (metrics, grads, after, before), JAX (losses, grads,
    new state)), in f64."""
    frozen = request.param == "frozen_single"
    out = step_pair("vmn_gca", "single" if frozen else "vmd",
                    3 if frozen else 5, _prepare, freeze=frozen, f32=False,
                    jax_modules=(JA,))
    return (request.param,) + out[torch.float64]


def test_gca_train_step_losses_match_jax(step):
    _, (metrics, _, _, _), (want, _, _) = step
    assert want["L1"] > 0 and set(want) <= set(metrics)
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4,
                                   atol=1e-12, err_msg=k)


def test_gca_train_step_gradients_match_jax(step):
    """Each module's gradient within relative L2 1e-6; under the frozen
    backbone the port gives its parameters no gradient and JAX a zero
    one."""
    kind, (_, got, _, _), (_, want, _) = step
    frozen = [n for n in want if kind == "frozen_single"
              and n.startswith(FROZEN)]
    for n in frozen:
        assert got[n] is None and not want[n].any(), n
    live = {n: g for n, g in got.items() if n not in frozen}
    assert live and all(g is not None for g in live.values())
    errs = module_errors(live, {n: want[n] for n in live})
    assert max(errs.values()) <= 1e-6, max(errs.items(), key=lambda e: e[1])


def test_gca_train_step_state_matches_jax(step):
    """Every BatchNorm's running mean and variance and every ``u`` and
    ``v`` after the step against JAX's new batch_stats and spectral (rtol
    1e-6); the frozen backbone's unchanged on both sides, bit for bit,
    the rest (most of it: a converged u may stay put) moved."""
    kind, (_, _, after, before), (_, _, new_state) = step
    assert sorted(k for k in after if k.endswith(STATS)) == sorted(new_state)
    moved = live = 0
    for k, want in new_state.items():
        if kind == "frozen_single" and k.startswith(FROZEN):
            assert torch.equal(after[k], before[k]), k
            np.testing.assert_array_equal(
                want, before[k].float().double().numpy(), err_msg=k)
            continue
        np.testing.assert_allclose(after[k].numpy(), want, rtol=1e-6,
                                   atol=1e-12, err_msg=k)
        live += 1
        moved += not torch.equal(after[k], before[k])
    assert live > 40 and moved > 0.9 * live
