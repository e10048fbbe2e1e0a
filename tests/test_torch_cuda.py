"""The CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA GPU (and no JAX, hence no conftest):
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Without a card every test here skips (the check runs in a fixture, so every
pytest worker collects the same tests).
"""
import numpy as np
import pytest
import torch

from tcvom_tpu_torch.infer.predict import StreamingPredictor
from tcvom_tpu_torch.models.full_model import TaskConfig, forward_eval
from tcvom_tpu_torch.models.registry import (build_model,
                                             calibrate_random_weights,
                                             converge_spectral_norms)
from tcvom_tpu_torch.ops import (cuda_build, edt_kernel, fam, fam_kernel,
                                 gca_attention)
from tcvom_tpu_torch.ops.image import max_pool_argmax_2x2, max_unpool_2x2

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    # local: on the card the suite runs with --noconftest (no JAX there)
    return np.random.RandomState(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("r,w,t", [(130, 70, 32), (200, 300, 32),
                                   (64, 1920, 256), (3, 5, 0)])
def test_edt_kernel_bit_exact(dev, rng, r, w, t):
    g2 = np.where(rng.rand(r, w) < 0.05, 0.0,
                  rng.randint(0, 3000, (r, w))).astype(np.float32)
    g2 = torch.from_numpy(g2).to(dev)
    got = edt_kernel.edt_row_pass(g2, t)
    torch.cuda.synchronize()
    assert torch.equal(got, edt_kernel.edt_row_pass_ref(g2, t))


@pytest.mark.parametrize("r,w,t", [
    (7, 1920, 0), (7, 1920, 1), (9, 1153, 32), (5, 2305, 256),
    (4, 20, 256),                       # W < T
    (6, 100, 33), (3, 9217, 75),        # W past the per-thread block, segment
    (2, 300, 4200)])                    # offsets past d^2's exact f32 range
def test_edt_kernel_edges_bit_exact(dev, rng, r, w, t):
    g2 = np.where(rng.rand(r, w) < 0.02, 0.0,
                  rng.randint(0, 3000, (r, w))).astype(np.float32)
    g2[1] = 1e7                         # a row with no seed
    g2 = torch.from_numpy(g2).to(dev)
    got = edt_kernel.edt_row_pass_cuda(g2, t)
    torch.cuda.synchronize()
    assert torch.equal(got, edt_kernel.edt_row_pass_ref(g2, t))


def test_edt_kernel_bit_exact_off_integers(dev, rng):
    """Non-integer, negative, huge and infinite values: a block holding a
    value the DPX form of the sweep does not take exactly runs the f32
    form, so the kernel stays bit-exact."""
    g2 = np.abs(rng.randn(6, 700) * 1e3).astype(np.float32)
    g2[1] *= -1                         # negative: the f32 form
    g2[2, 5] = -0.0
    g2[3] += 3e7                        # beyond 2^24
    g2[4, 7] = np.inf
    g2 = torch.from_numpy(g2).to(dev)
    got = edt_kernel.edt_row_pass_cuda(g2, 40)
    torch.cuda.synchronize()
    assert torch.equal(got, edt_kernel.edt_row_pass_ref(g2, 40))


def _fam_inputs(rng, shape, dtype, dev):
    b, h, w, c = shape
    q = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    m = torch.from_numpy((rng.rand(b, h, w, 1) > 0.4).astype(np.float32))
    return [t.to(dev, dtype) for t in (q, k, m)]


@pytest.mark.parametrize("shape,window", [
    ((2, 8, 16, 8), 3), ((1, 16, 24, 32), 7), ((2, 16, 24, 256), 7),
    ((1, 5, 7, 300), 5), ((1, 3, 4, 1), 9), ((2, 16, 24, 128), 7),
    ((2, 136, 240, 128), 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fam_kernel_matches_plain(dev, rng, shape, window, dtype):
    q, k, m = _fam_inputs(rng, shape, dtype, dev)
    got, lg = fam.fam_attention(q, k, m, window)
    torch.cuda.synchronize()
    want, _ = fam.fam_attention_ref(q, k, m, window)
    assert lg is None and got.dtype == dtype
    # f32: summation order only; bf16: both accumulate in f32 and round the
    # output once to bf16 (2^-8 relative)
    tol = (dict(atol=1e-5, rtol=0) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("c", [1, 8, 32, 256, 300])
@pytest.mark.parametrize("window", [3, 5, 7, 9])
def test_fam_bf16_tensor_core_kernel_edges(dev, rng, c, window):
    """The bf16 tensor-core kernel at ragged tiles (H, W not multiples of
    8), every channel chunking, a fully masked frame (exactly 0) and logits
    of large magnitude (q, k x 30, so the max subtraction matters). bf16:
    both accumulate in f32; the kernel rounds its weights to bf16, the
    plain version only its output (2^-8 relative each)."""
    q, k, m = _fam_inputs(rng, (3, 13, 21, c), torch.bfloat16, dev)
    q[2], k[2] = q[2] * 30, k[2] * 30
    m[1] = 0
    got = fam_kernel.fam_window(q, k, m, window)
    torch.cuda.synchronize()
    want, _ = fam.fam_attention_ref(q, k, m, window)
    assert not got[1].any()
    scale = torch.tensor([1.0, 1.0, 30.0], device=dev).view(3, 1, 1, 1)
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("c", [1, 8, 32, 256, 300])
@pytest.mark.parametrize("window", [3, 5, 7, 9])
def test_fam_f32_tensor_core_kernel_edges(dev, rng, c, window):
    """Both f32 entries (3xTF32 on the tensor cores) at ragged tiles (H, W
    not multiples of 8), every channel chunking (32 f32 channels a chunk;
    C = 1 and 300 take the unvectorised staging), a fully masked frame
    (out and logits exactly 0) and logits of large magnitude (q, k x 30).
    Frame 0 against the plain version at the f32 entries' 1e-5; the two
    entries' out bit for bit (one kernel). Frame 2 against the plain
    version in f64, out / 30 within 1e-3 and logits / 900 within 1e-5:
    its logits spread ~900 wide, and there f32's own rounding moves the
    weights of near-tied neighbours (the plain f32 version misses the f64
    one by up to 2e-4 in out / 30 on these inputs)."""
    q, k, m = _fam_inputs(rng, (3, 13, 21, c), torch.float32, dev)
    q[2], k[2] = q[2] * 30, k[2] * 30
    m[1] = 0
    out = fam_kernel.fam_window(q, k, m, window)
    got, lg = fam_kernel.fam_window_logits(q, k, m, window)
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    assert not got[1].any() and not lg[1].any()
    want, want_lg = fam.fam_attention_ref(q[:1], k[:1], m[:1], window)
    torch.testing.assert_close(got[:1], want, atol=1e-5, rtol=0)
    torch.testing.assert_close(lg[:1], want_lg, atol=1e-5, rtol=0)
    want, want_lg = fam.fam_attention_ref(
        *(t[2:].double() for t in (q, k, m)), window)
    torch.testing.assert_close(got[2:].double() / 30, want / 30, atol=1e-3,
                               rtol=0)
    torch.testing.assert_close(lg[2:].double() / 900, want_lg / 900,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("logits", [False, True])
def test_fam_rejects_windows_past_its_tiling(dev, rng, dtype, logits):
    """Every entry refuses window 11: the wrapper raises before launching,
    and the C entry itself returns cudaErrorInvalidValue (1)."""
    q, k, m = _fam_inputs(rng, (1, 4, 6, 8), dtype, dev)
    wrapper = fam_kernel.fam_window_logits if logits else fam_kernel.fam_window
    cuda_build.LAUNCHES.clear()
    with pytest.raises(ValueError, match="odd windows up to"):
        wrapper(q, k, m, fam_kernel.MMA_MAX_WINDOW + 2)
    assert not cuda_build.LAUNCHES
    outs = [torch.empty_like(q)] + ([q.new_empty(1, 4, 6, 121)] if logits
                                    else [])
    rc = fam_kernel._entry(dtype, logits)(
        q.data_ptr(), k.data_ptr(), m.data_ptr(),
        *(t.data_ptr() for t in outs), 1, 4, 6, 8, 11, 8 ** -0.5,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    assert rc == 1


@pytest.mark.parametrize("shape,window", [
    ((2, 8, 16, 8), 3), ((1, 16, 24, 32), 7), ((2, 16, 24, 256), 7),
    ((1, 5, 7, 300), 5), ((1, 3, 4, 1), 9), ((6, 64, 64, 256), 7),
    ((2, 136, 240, 128), 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fam_logits_kernel_matches_plain(dev, rng, shape, window, dtype):
    q, k, m = _fam_inputs(rng, shape, dtype, dev)
    m[0] = 0                          # a fully masked frame
    got, lg = fam.fam_attention(q, k, m, window, need_logits=True)
    torch.cuda.synchronize()
    want, want_lg = fam.fam_attention_ref(q, k, m, window)
    assert got.dtype == lg.dtype == dtype
    assert lg.shape == shape[:3] + (window * window,)
    assert not lg[0].any() and not got[0].any()
    tol = (dict(atol=1e-5, rtol=0) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(lg.float(), want_lg.float(), **tol)


@pytest.mark.parametrize("need_logits", [True, False])
def test_fam_gradients_match_plain(dev, rng, need_logits):
    """The autograd Function (kernel forward, plain VJP backward) against
    the plain version's autograd, with both cotangents; a CUDA call under
    autograd never drops the gradient, logits or not."""
    q, k, m = _fam_inputs(rng, (2, 12, 20, 64), torch.float32, dev)
    d_out = torch.randn(q.shape, device=dev)
    d_lg = torch.randn(q.shape[:3] + (25,), device=dev)
    grads = []
    for f in (fam.fam_attention, lambda *a, **kw: fam.fam_attention_ref(*a)):
        q_, k_ = q.clone().requires_grad_(), k.clone().requires_grad_()
        out, lg = f(q_, k_, m, 5, need_logits=need_logits)
        loss = (out * d_out).sum()
        if need_logits:
            loss = loss + (lg * d_lg).sum()
        grads.append(torch.autograd.grad(loss, (q_, k_)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_wrappers_reject_what_the_kernels_do_not_take(dev, rng):
    q, k, m = _fam_inputs(rng, (1, 4, 6, 8), torch.float32, dev)
    with pytest.raises(ValueError):
        fam_kernel.fam_window(q.transpose(1, 2), k, m, 3)      # layout
    with pytest.raises(ValueError):
        fam_kernel.fam_window(q, k.bfloat16(), m, 3)           # dtype
    with pytest.raises(ValueError):
        fam_kernel.fam_window(q, k, m, 4)                      # even window
    with pytest.raises(ValueError):
        fam_kernel.fam_window_logits(q, k, m[..., 0], 3)       # mask shape
    with pytest.raises(ValueError):
        edt_kernel.edt_row_pass(q[0, :, :, 0], 2)              # stride
    with pytest.raises(ValueError):
        edt_kernel.edt_row_pass(torch.zeros(4, 4, device=dev), 10 ** 5)


def test_launch_counts(dev, rng):
    q, k, m = _fam_inputs(rng, (1, 4, 6, 8), torch.float32, dev)
    cuda_build.LAUNCHES.clear()
    fam.fam_attention(q, k, m, 3)
    fam.fam_attention(q, k, m, 3, need_logits=True)
    fam.fam_attention(q.requires_grad_(), k, m, 3)
    edt_kernel.edt_row_pass(torch.zeros(4, 8, device=dev), 2)
    edt_kernel.edt_row_pass_ref(torch.zeros(4, 8, device=dev), 2)
    assert cuda_build.LAUNCHES == {"fam_window": 1, "fam_window_logits": 2,
                                   "edt_row": 1}


@pytest.mark.parametrize("name", ["vmn_fba", "vmn_dim", "vmn_index",
                                  "vmn_gca"])
def test_stream_on_card_matches_cpu(dev, rng, name):
    """Small f32 stream through both kernels (FBA; the FAM kernel alone at
    C = 256 for DIM, C = 32 for IndexNet and C = 128 for GCA, whose
    weights are first calibrated so that the mattes are not all 0, GCA's
    spectral-norm vectors set to its weights' singular vectors before)
    against the CPU (plain) run of the same weights: uint8 mattes within
    one level."""
    model = build_model(name, agg_window=3, layers=(1, 1, 1, 1),
                        device="cpu")
    if name == "vmn_gca":
        converge_spectral_norms(model)
    cfg = TaskConfig(model=name, agg_window=3)
    imgs = rng.randint(0, 256, (3, 1, 64, 96, 3)).astype(np.uint8)
    tri = np.zeros((1, 64, 96, 1), np.uint8)
    tri[:, 10:50, 10:80] = 128
    tri[:, 25:35, 30:60] = 255
    if name != "vmn_fba":
        clip = (torch.from_numpy(imgs[None, :, 0]).float(),
                torch.from_numpy(np.stack([tri] * 3, 1)).float())
        calibrate_random_weights(model, lambda: forward_eval(model, *clip,
                                                             cfg))
    outs = {}
    for where in ("cpu", "cuda"):
        sp = StreamingPredictor(model, cfg, fgbg=False, quantize=True,
                                device=where)
        cuda_build.LAUNCHES.clear()
        state, res = None, []
        for img in imgs:
            state, o = sp.step(state, img, tri)
            if o is not None:
                res.append(o.cpu().numpy())
        res.append(sp.flush(state).cpu().numpy())
        outs[where] = np.stack(res).astype(int)
        want = ({} if where == "cpu" else {"fam_window": 3} if
                name != "vmn_fba" else {"fam_window": 3, "edt_row": 3})
        assert cuda_build.LAUNCHES == want
    unknown = np.broadcast_to(tri[..., 0] == 128, outs["cpu"].shape)
    assert ((outs["cpu"][unknown] > 0) & (outs["cpu"][unknown] < 255)
            ).mean() > 0.1
    diff = np.abs(outs["cpu"] - outs["cuda"])
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_argmax_pool_on_card_matches_cpu(dev, rng, dtype):
    """DIM's pool and unpool on the card, with exact ties in windows (ReLU's
    zeros and repeated values), against the CPU's: the same first max."""
    x = torch.from_numpy(rng.randint(-2, 3, (2, 8, 34, 50)).astype(
        np.float32)).clamp_min(0).to(dtype)
    want = max_pool_argmax_2x2(x)
    got = max_pool_argmax_2x2(x.to(dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(max_unpool_2x2(*got).cpu(), max_unpool_2x2(*want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gca_attention_core_on_card_matches_cpu(dev, rng, dtype):
    """GCA's attention core on the card (cuBLAS products; in bf16 with f32
    output) against the CPU's on the same values: f32 to 1e-4 (summation
    order), bf16 to 2e-2 (the softmax weights rounded to bf16 in both)."""
    f = torch.from_numpy((0.3 * rng.randn(2, 64, 17, 30)).astype(np.float32))
    alpha = torch.from_numpy(rng.randn(2, 128, 34, 60).astype(np.float32))
    unk = torch.from_numpy((rng.rand(2, 1, 17, 30) > 0.6).astype(np.float32))
    args = [t.to(dtype) for t in (f, alpha, unk)]
    want = gca_attention.guided_attention_core(*args)
    got = gca_attention.guided_attention_core(*(t.to(dev) for t in args))
    assert got.dtype == want.dtype == torch.float32
    tol = (dict(atol=1e-4, rtol=0) if dtype == torch.float32
           else dict(atol=2e-2, rtol=0))
    torch.testing.assert_close(got.cpu(), want, **tol)


# -- training (the BatchNorm backbones) --------------------------------------

@pytest.mark.parametrize("shape", [(24, 64, 64, 32), (36, 64, 64, 128),
                                   (12, 68, 120, 32), (12, 68, 120, 128)])
def test_fam_logits_training_widths_forward_and_backward(dev, rng, shape):
    """The logits kernel at IndexNet's and GCA's training and validation
    batches (window 7), forward (out, logits) and, through the autograd
    Function, dq and dk against the plain version's autograd."""
    q, k, m = _fam_inputs(rng, shape, torch.float32, dev)
    d_out = torch.randn(q.shape, device=dev)
    d_lg = torch.randn(q.shape[:3] + (49,), device=dev)
    outs = []
    for f in (fam.FamAttention.apply, fam.fam_attention_ref):
        q_, k_ = q.clone().requires_grad_(), k.clone().requires_grad_()
        out, lg = f(q_, k_, m, 7)
        outs.append((out.detach(), lg.detach()) + torch.autograd.grad(
            (out, lg), (q_, k_), (d_out, d_lg)))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_batchnorm_training_update_on_card_matches_cpu(dev, rng):
    """The port's BatchNorm in training, twice, then in eval: outputs and
    running statistics on the card against the CPU's."""
    from tcvom_tpu_torch.models.layers import BatchNorm

    bns = [BatchNorm(16), BatchNorm(16).to(dev)]
    bns[1].load_state_dict(bns[0].state_dict())
    xs = [torch.from_numpy(rng.randn(6, 16, 9, 7).astype(np.float32) * 2 + 1)
          for _ in range(3)]
    for i, x in enumerate(xs):
        outs = [bn.train(i < 2)(x.to(bn.weight.device)) for bn in bns]
        torch.testing.assert_close(outs[1].cpu(), outs[0], atol=1e-5, rtol=0)
    for key in ("running_mean", "running_var", "num_batches_tracked"):
        torch.testing.assert_close(getattr(bns[1], key).cpu(),
                                   getattr(bns[0], key), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["vmn_dim", "vmn_index", "vmn_gca"])
def test_train_step_on_card_matches_cpu(dev, rng, name):
    """One ``MattingTrainer.train_step`` (B = 1, S = 5, 64x64, window 3)
    through the logits kernel on the card against the CPU's from the same
    weights, batch and radius (IndexNet's dropout in eval): losses within
    rtol 1e-4; running statistics, u and v within 1e-4; each module's
    gradient within 1e-3, or within twice the largest move the CPU step
    itself makes when its inputs are jittered by relative 1e-6, where that
    is larger (the L1 losses' signs and DIM's pool choices flip at
    rounding)."""
    from chip_smoke import module_grad_errors
    from tcvom_tpu_torch.models.layers import Dropout
    from tcvom_tpu_torch.train.trainer import MattingTrainer

    cfg = TaskConfig(model=name, agg_window=3)
    yy, xx = np.mgrid[:64, :64]
    a = np.stack([np.clip((18 - np.hypot(yy - 30 - 2 * t, xx - 32 + t)) / 6,
                          0, 1) * 255 for t in range(5)])[None, ..., None]
    batch = {"a": a.astype(np.float32),
             **{k: rng.randint(0, 256, (1, 5, 64, 64, 3)).astype(np.float32)
                for k in ("fg", "bg")}}
    jittered = dict(batch, **{k: (batch[k] * (1 + 1e-6 * rng.randn(
        *batch[k].shape))).astype(np.float32) for k in ("fg", "bg")})
    weights = None
    runs = []
    for device, data in (("cpu", batch), ("cpu", jittered), (dev, batch)):
        trainer = MattingTrainer(cfg, "vmd", device=device)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        if weights is None:
            if name == "vmn_gca":
                converge_spectral_norms(state.model)
            weights = {k: v.clone() for k, v in
                       state.model.state_dict().items()}
        state.model.load_state_dict(weights)
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.eval()
        cuda_build.LAUNCHES.clear()
        _, metrics = trainer.train_step(
            state, {k: torch.from_numpy(v).to(device)
                    for k, v in data.items()}, radius=torch.tensor([4]))
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.cpu() for n, p in
                      state.model.named_parameters()},
                     {n: b.cpu() for n, b in state.model.named_buffers()},
                     dict(cuda_build.LAUNCHES)))
    (m_cpu, g_cpu, b_cpu, _), (_, g_jit, _, _), (m_gpu, g_gpu, b_gpu,
                                                 launches) = runs
    assert launches == {"fam_window_logits": 1}
    for k, v in m_cpu.items():
        np.testing.assert_allclose(m_gpu[k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    for k, v in b_cpu.items():
        torch.testing.assert_close(b_gpu[k], v, atol=1e-4, rtol=1e-4)
    floor = module_grad_errors(g_jit, g_cpu)[0][0]
    worst = module_grad_errors(g_gpu, g_cpu)[0]
    assert worst[0] <= max(1e-3, 2 * floor), (worst, floor)


@pytest.mark.parametrize("name", ["vmn_fba", "vmn_gca"])
def test_nccl_one_rank_step_matches_the_plain_step(dev, rng, name,
                                                   monkeypatch, tmp_path):
    """A DDP train step in a process group of one rank over NCCL (a
    trainer made in the group) against the plain step on the card (a
    trainer made before the group started), from the same
    weights, batch and radius (B = 1, S = 3, 64x64, window 3, FBA at depth
    (1, 1, 1, 1)), deterministic algorithms where torch has them: losses
    within rtol 1e-6, each module's gradient within relative L2 1e-5,
    every running statistic and u, v within 1e-6; the logits kernel
    launched once in each."""
    import torch.distributed as dist

    from chip_smoke import module_grad_errors
    from tcvom_tpu_torch import parallel
    from tcvom_tpu_torch.train.trainer import MattingTrainer

    for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = TaskConfig(model=name, agg_window=3)
        data = {"a": np.clip(rng.rand(1, 3, 64, 64, 1) * 600 - 200, 0, 255),
                "fg": rng.rand(1, 3, 64, 64, 3) * 255,
                "bg": rng.rand(1, 3, 64, 64, 3) * 255}
        runs, weights = [], None
        for ddp in (False, True):
            if ddp:
                assert parallel.init_from_env(
                    "cuda", init_method=f"file://{tmp_path}/pg"
                ) == torch.device("cuda", 0)
            trainer = MattingTrainer(cfg, "vmd", layers=(1, 1, 1, 1),
                                     device=dev)
            state = trainer.init_state(torch.Generator().manual_seed(0))
            if weights is None:
                if name == "vmn_gca":
                    converge_spectral_norms(state.model)
                weights = {k: v.clone() for k, v in
                           state.model.state_dict().items()}
            state.model.load_state_dict(weights)
            cuda_build.LAUNCHES.clear()
            _, metrics = trainer.train_step(
                state, {k: torch.from_numpy(v.astype(np.float32)).to(dev)
                        for k, v in data.items()}, radius=torch.tensor([4]))
            runs.append(({k: float(v) for k, v in metrics.items()},
                         {n: p.grad.cpu() for n, p in
                          state.model.named_parameters()},
                         {n: b.cpu() for n, b in
                          state.model.named_buffers()},
                         dict(cuda_build.LAUNCHES), state.ddp))
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()
    (m_plain, g_plain, b_plain, n_plain, _), (m_ddp, g_ddp, b_ddp, n_ddp,
                                              wrapper) = runs
    assert wrapper is not None and n_plain == n_ddp
    assert n_ddp["fam_window_logits"] == 1
    for k, v in m_plain.items():
        np.testing.assert_allclose(m_ddp[k], v, rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    for k, v in b_plain.items():
        torch.testing.assert_close(b_ddp[k], v, atol=1e-6, rtol=1e-6)
    worst = module_grad_errors(g_ddp, g_plain)[0]
    assert worst[0] <= 1e-5, worst
