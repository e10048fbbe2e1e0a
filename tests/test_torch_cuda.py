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
from tcvom_tpu_torch.models.full_model import TaskConfig
from tcvom_tpu_torch.models.registry import build_model
from tcvom_tpu_torch.ops import cuda_build, edt_kernel, fam, fam_kernel

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
    ((1, 5, 7, 300), 5), ((1, 3, 4, 1), 9)])
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
    ((1, 5, 7, 300), 5), ((1, 3, 4, 1), 9), ((6, 64, 64, 256), 7)])
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


def test_stream_on_card_matches_cpu(dev, rng):
    """Small f32 stream through both kernels against the CPU (plain) run of
    the same weights: uint8 mattes within one level."""
    model = build_model("vmn_fba", agg_window=3, layers=(1, 1, 1, 1),
                        device="cpu")
    cfg = TaskConfig(model="vmn_fba", agg_window=3)
    imgs = rng.randint(0, 256, (3, 1, 64, 96, 3)).astype(np.uint8)
    tri = np.zeros((1, 64, 96, 1), np.uint8)
    tri[:, 10:50, 10:80] = 128
    tri[:, 25:35, 30:60] = 255
    outs = {}
    for where in ("cpu", "cuda"):
        sp = StreamingPredictor(model, cfg, fgbg=False, quantize=True,
                                device=where)
        state, res = None, []
        for img in imgs:
            state, o = sp.step(state, img, tri)
            if o is not None:
                res.append(o.cpu().numpy())
        res.append(sp.flush(state).cpu().numpy())
        outs[where] = np.stack(res).astype(int)
    diff = np.abs(outs["cpu"] - outs["cuda"])
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
