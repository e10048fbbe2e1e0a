"""The bf16 training recipe (``TRAIN.BF16``: the port's
``MattingTrainer(compute_dtype=torch.bfloat16)``) against the JAX
package's (``compute_dtype=jnp.bfloat16``, tcvom_tpu/train/trainer.py:
102-112, :158-199), on the CPU.

JAX casts the parameters, the state and the batch to bf16 inside the
step; ``preprocess`` then promotes the network's input to f32 (the f32
mean and std) and every conv casts its bf16 weight up to it. So the
recipe is f32 arithmetic on bf16-rounded weights and state, with
gradients rounded to bf16 by the casts' backward, and bf16 arithmetic
only in the data synthesis, the loss targets (FBA's Laplacian pyramid)
and GCA's power iterations. Held here:

- the BatchNorm and spectral-norm layers with bf16 parameters and state
  against flax's ``nn.BatchNorm``, ``RawBatchNorm`` and ``SNConv``;
- which convolutions and matrix products run in bf16, by shape
  signature, against a ``make_jaxpr`` of JAX's bf16 ``train_step``, for
  all four VMN models (FAM's q and k are f32 on both sides);
- the bf16 step of ``vmn_fba`` and ``vmn_gca`` against JAX's: losses,
  each module's gradient, the BatchNorm statistics, ``u`` and ``v``;
- the master state of ``vmn_dim`` and ``vmn_index`` staying f32.

JAX's side is compiled without XLA's excess precision (:func:`written`),
so that it rounds where the recipe is written to round.

Weights: the port's (FBA at depth ``LAYERS``; GCA's prepared as in
test_torch_train_gca.py), carried to JAX through its own converter over a
``jax.eval_shape`` of the init. The trimap radius is the one JAX draws.
"""
import collections

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tcvom_tpu.models import fba as JF
from tcvom_tpu.models import full_model as JFM
from tcvom_tpu.models import layers as JL
from tcvom_tpu.models import registry as JR
from tcvom_tpu.models import vmn as JV
from tcvom_tpu.train import trainer as JT
from tcvom_tpu_torch.models import full_model as TFM
from tcvom_tpu_torch.models import layers as TL
from tcvom_tpu_torch.models.registry import build_model
from tcvom_tpu_torch.ops import fam as TFAM
from tcvom_tpu_torch.train import trainer as TT
from tcvom_tpu_torch.utils.convert import jax_to_torch_state_dict
from test_torch_dim import carried
from test_torch_train_bn import (KEY, _clip, jax_radius,  # noqa: F401
                                 module_errors, one_thread,
                                 port_train_step)
from test_torch_train_gca import _prepare as _prepare_gca

H = W = 64
WINDOW = 3
LAYERS = (1, 1, 1, 1)
BF16 = jnp.bfloat16


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One unit in the last place of bf16 (8 significant bits) at |x|."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_within_bf16_ulp(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / bf16_ulp(want)
    assert err.max() <= 1.0, (what, err.max())


def written(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision: each bf16
    op rounds its result, as the recipe is written and as JAX runs it op
    by op (or on a TPU, where bf16 is native). ``jit``'s default keeps
    some bf16 results in f32 where only their f32 cast is read: a
    spectral-norm quotient, flax's momentum product, the sum of a bf16
    parameter's gradients from two uses (FAM's key conv, GCA's
    ``kernel_bar``), each one bf16 rounding, ~1e-3 of the value."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _cast(tree, dtype):
    """JAX's ``_cast_compute``: floating leaves to ``dtype``."""
    return jax.tree.map(lambda a: a.astype(dtype) if jnp.issubdtype(
        a.dtype, jnp.floating) else a, tree)


# -- the layers ---------------------------------------------------------------

@pytest.mark.parametrize("jax_bn", ["flax", "raw"])
def test_batchnorm_bf16_matches_jax(rng, jax_bn):
    """Two training calls with bf16 scale, bias and statistics on an f32
    input, then (flax) one in eval, as a frozen backbone runs: the outputs
    and the new running statistics (stored f32) against JAX's, compiled by
    :func:`written`. The statistics agree within 1 bf16 ulp (the batch
    statistics' f32 sums reassociate). The eval call, from JAX's
    statistics, within 2 bf16 ulps of its bracket ``rsqrt(var + eps) *
    scale`` (XLA's bf16 rsqrt is not always the correctly rounded value
    torch's is, and the product rounds again: 1-2 ulps apart in some
    channels)."""
    c = 6
    xs = [(rng.randn(4, 5, 3, c) * 3 + 1).astype(np.float32)
          for _ in range(3)]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    stats = {"mean": rng.randn(c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jmod = (JL.BatchNorm() if jax_bn == "flax"
            else JL.RawBatchNorm(features=c))
    train_kw = ({"use_running_average": False} if jax_bn == "flax"
                else {"train": True})
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    state = {k: jnp.asarray(v) for k, v in stats.items()}

    def jax_train(state, x):
        y, upd = jmod.apply({"params": _cast(params, BF16),
                             "batch_stats": _cast(state, BF16)}, x,
                            mutable=["batch_stats"], **train_kw)
        return y, jax.tree.map(lambda n: n.astype(jnp.float32),
                               upd["batch_stats"])

    bn = TL.BatchNorm(c).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    cast = {"weight": torch.from_numpy(scale).bfloat16(),
            "bias": torch.from_numpy(bias).bfloat16()}
    for x in xs[:2]:
        want, state = written(jax_train, state, jnp.asarray(x))
        got = torch.func.functional_call(
            bn, cast, (torch.from_numpy(x).permute(0, 3, 1, 2),))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        assert_within_bf16_ulp(bn.running_mean.numpy(), state["mean"],
                               "mean")
        assert_within_bf16_ulp(bn.running_var.numpy(), state["var"], "var")
    assert bn.running_mean.dtype == torch.float32
    if jax_bn == "flax":
        want = written(lambda st, x: jmod.apply(
            {"params": _cast(params, BF16), "batch_stats": _cast(st, BF16)},
            x, use_running_average=True), state, jnp.asarray(xs[2]))
        with torch.no_grad():      # JAX's statistics, which round alike
            bn.running_mean.copy_(torch.tensor(np.asarray(state["mean"])))
            bn.running_var.copy_(torch.tensor(np.asarray(state["var"])))
        got = torch.func.functional_call(
            bn.eval(), cast, (torch.from_numpy(xs[2]).permute(0, 3, 1, 2),))
        got = got.permute(0, 2, 3, 1).detach().numpy()
        # (x - mean) * bracket, whose bf16 values may lie 2 ulps apart
        scaled = np.abs(np.asarray(want) - cast["bias"].float().numpy())
        assert (np.abs(got - np.asarray(want)) <= 2.0 ** -6 * scaled
                + 1e-6).all()


_SN = {"conv": (dict(features=7, kernel_size=3, strides=1, padding=1),
                (2, 9, 10, 5)),
       "transpose": (dict(features=4, kernel_size=4, strides=2, padding=1,
                          transpose=True), (2, 5, 6, 6))}


@pytest.mark.parametrize("kind", list(_SN))
def test_sn_conv_bf16_matches_jax(rng, kind):
    """A train-mode call with a bf16 ``kernel_bar`` and bf16 ``u``, ``v``
    on an f32 input: the power iteration, sigma and ``kernel_bar / sigma``
    in bf16 (JAX's SNConv there), the conv in f32. The new ``u``, ``v``
    (stored f32) within 1 bf16 ulp of JAX's and the f32 output within
    1e-5, JAX compiled by :func:`written`. The f32 kernel's gradient
    (through the cast) within relative L2 1e-2: its sigma term scales
    the whole of ``u v^T`` by one bf16 number, a sum over the kernel in
    f32 that the two frameworks add up in other orders (OIHW here, HWIO
    there) and may round to neighbouring bf16 values. Op for op in
    torch, JAX's backward is bit-identical here (6.3e-3 apart for
    ``conv``; JAX's plain ``jit``, which keeps that number unrounded, is
    1.6e-3 from its written step)."""
    kw, shape = _SN[kind]
    jmod = JL.SNConv(**kw)
    x = rng.randn(*shape).astype(np.float32)
    variables = jmod.init({"params": jax.random.PRNGKey(3)}, x)
    kernel = np.asarray(variables["params"]["kernel_bar"])
    spectral = {k: np.asarray(v) for k, v in variables["spectral"].items()}
    cot = rng.randn(*jmod.apply(variables, x).shape).astype(np.float32)

    def jax_step(kernel):
        def loss(k):
            y, upd = jmod.apply({"params": {"kernel_bar": k.astype(BF16)},
                                 "spectral": _cast(spectral, BF16)},
                                x, True, mutable=["spectral"])
            return jnp.sum(y * cot), (y, upd["spectral"])
        return jax.value_and_grad(loss, has_aux=True)(kernel)

    (_, (want, new)), grad = written(jax_step, jnp.asarray(kernel))
    order = (2, 3, 0, 1) if kw.get("transpose") else (3, 2, 0, 1)
    port = TL.SNConv2d(shape[-1], kw["features"], kw["kernel_size"],
                       kw["strides"], kw["padding"],
                       transpose=kw.get("transpose", False)).train()
    master = torch.from_numpy(np.transpose(kernel, order).copy())
    master.requires_grad_(True)
    with torch.no_grad():
        port.module.weight_u.copy_(torch.tensor(spectral["u"]))
        port.module.weight_v.copy_(torch.tensor(spectral["v"]))
    y = torch.func.functional_call(
        port, {"module.weight_bar": master.bfloat16()},
        (torch.from_numpy(x).permute(0, 3, 1, 2),))
    assert y.dtype == torch.float32
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    for name in ("u", "v"):
        got = getattr(port.module, f"weight_{name}")
        assert got.dtype == torch.float32
        assert_within_bf16_ulp(got.numpy(), new[name].astype(jnp.float32),
                               name)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    g = np.transpose(np.asarray(grad.astype(jnp.float32)), order)
    err = np.linalg.norm(master.grad.numpy() - g) / np.linalg.norm(g)
    assert err <= 1e-2, err


# -- which products run in bf16 -----------------------------------------------

_PRODUCTS = ("convolution", "mm", "mv", "dot", "bmm", "addmm", "addmv",
             "baddbmm", "outer", "vdot")


class _Products(TorchDispatchMode):
    """Logs each forward convolution and matrix product: (kind, dtype,
    shape signature)."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _PRODUCTS:
            ts = [a for a in args if isinstance(a, torch.Tensor)][:2]
            if name == "convolution":
                x, w = ts
                groups = args[8]
                if args[6]:          # transposed: weight IOHW
                    sig = (x.shape[2], x.shape[3], w.shape[0],
                           w.shape[1] * groups, w.shape[2], w.shape[3],
                           groups)
                else:
                    sig = (x.shape[2], x.shape[3], w.shape[1] * groups,
                           w.shape[0], w.shape[2], w.shape[3], groups)
                self.seen["conv", str(x.dtype)[6:], sig] += 1
            else:
                self.seen["dot", str(ts[0].dtype)[6:],
                          frozenset(d for t in ts for d in t.shape)] += 1
        return func(*args, **(kwargs or {}))


def _jax_products(jaxpr, seen):
    """The same log of a jaxpr, sub-jaxprs included. A conv's signature
    is (H, W, in, out, kh, kw, groups) of its lhs and rhs specs; a dot's
    the set of its operands' dims."""
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "conv_general_dilated":
            lhs, rhs = (v.aval for v in e.invars)
            ls, rs, _ = e.params["dimension_numbers"]
            g = e.params["feature_group_count"]
            sig = (lhs.shape[ls[2]], lhs.shape[ls[3]],
                   rhs.shape[rs[1]] * g, rhs.shape[rs[0]],
                   rhs.shape[rs[2]], rhs.shape[rs[3]], g)
            seen["conv", str(lhs.dtype), sig] += 1
        elif name == "dot_general":
            seen["dot", str(e.invars[0].aval.dtype),
                 frozenset(d for v in e.invars for d in v.aval.shape)] += 1
        for p in e.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if hasattr(sub, "eqns"):
                    _jax_products(sub, seen)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    _jax_products(sub.jaxpr, seen)


def _bf16_kinds(seen):
    return {(kind, sig) for kind, dt, sig in seen if dt == "bfloat16"}


@pytest.mark.parametrize("name", ["vmn_fba", "vmn_dim", "vmn_index",
                                  "vmn_gca"])
def test_bf16_dtype_map_matches_jax(name, monkeypatch):
    """JAX's bf16 ``train_step`` traced (``make_jaxpr`` over the ``eval_shape``
    of its state, nothing compiled) and the port's bf16 step run under a
    dispatch log (FBA at depth ``LAYERS``, the others have no depth knob), B
    = 1 (IndexNet 2), S = 5, 64x64, window 3: the same set of convolutions
    and matrix products in bf16 by shape signature (counts differ: JAX's
    list holds the backward's products, the port's only the forward's), and
    no bf16 conv but a 5x5 depthwise Gaussian of 1 or 3 channels (FBA's
    pyramid of the targets). None of the network's convolutions runs in
    bf16; GCA's bf16 products are its power iterations and sigmas. FAM's q
    and k are f32 on both sides."""
    b = 2 if name == "vmn_index" else 1
    fam_dtypes = {"jax": set(), "port": set()}
    jax_fam, port_fam = JV.fam_attention, TFAM.fam_attention

    def spy(which, fn):
        def wrapped(q, k, *a, **kw):
            fam_dtypes[which].add((str(q.dtype).removeprefix("torch."),
                                   str(k.dtype).removeprefix("torch.")))
            return fn(q, k, *a, **kw)
        return wrapped

    monkeypatch.setattr(JV, "fam_attention", spy("jax", jax_fam))
    monkeypatch.setattr(TFAM, "fam_attention", spy("port", port_fam))
    jtr = JT.MattingTrainer(JFM.TaskConfig(model=name, agg_window=WINDOW),
                            "vmd", compute_dtype=BF16)
    if name == "vmn_fba":
        jtr.module = _fba_jax_module()
    sample = {k: jax.ShapeDtypeStruct((b, 5, H, W, c), jnp.float32)
              for k, c in (("a", 1), ("fg", 3), ("bg", 3))}
    state = jax.eval_shape(jtr.init_state, jax.random.PRNGKey(0), sample)
    want = collections.Counter()
    _jax_products(jax.make_jaxpr(jtr.train_step)(
        state, sample, jax.random.PRNGKey(1)).jaxpr, want)

    trainer = TT.MattingTrainer(TFM.TaskConfig(model=name,
                                               agg_window=WINDOW),
                                "vmd", device="cpu", layers=LAYERS,
                                compute_dtype=torch.bfloat16)
    st = trainer.init_state()
    batch = {k: torch.from_numpy(np.repeat(v, b, axis=0))
             for k, v in _clip(5, 5).items()}
    with _Products() as log:
        trainer.train_step(st, batch, radius=torch.full((b,), 3))
    got = log.seen

    assert _bf16_kinds(got) == _bf16_kinds(want)
    assert any(k[1] == "float32" for k in got)
    for kind, dt, sig in want:
        if dt == "bfloat16" and kind == "conv":
            assert sig[4:6] == (5, 5) and sig[2] == sig[3] == sig[6] in (1, 3)
    bf16_dots = {k for k in _bf16_kinds(want) if k[0] == "dot"}
    assert bool(bf16_dots) == (name == "vmn_gca")
    bf16_convs = {k for k in _bf16_kinds(want) if k[0] == "conv"}
    assert bool(bf16_convs) == (name == "vmn_fba")
    assert fam_dtypes == {"jax": {("float32", "float32")},
                          "port": {("float32", "float32")}}


# -- the bf16 step against JAX's ----------------------------------------------

def jax_step(jmod, variables, batch, cfg, compute_dtype, excess=False):
    """JAX's train-step gradient (tcvom_tpu/train/trainer.py:166-185), with
    ``_cast_compute`` to ``compute_dtype`` (None: f32): (losses, the
    gradients as the port's state_dict, the new state, cast back to f32,
    as the port's state_dict), compiled by :func:`written`."""
    params = jax.tree.map(lambda a: jnp.asarray(np.array(a), jnp.float32),
                          variables["params"])
    state = {k: jax.tree.map(lambda a: jnp.asarray(np.array(a),
                                                   jnp.float32), v)
             for k, v in variables.items() if k != "params"}

    def cast(tree):
        return tree if compute_dtype is None else _cast(tree, compute_dtype)

    b = cast({k: jnp.asarray(v) for k, v in batch.items()})

    def loss_fn(p):
        losses, _, new_state = JFM.forward_vmd(
            jmod, {"params": cast(p), **cast(state)}, KEY, b, cfg,
            train=True, mutable=list(state) or False)
        total = sum(JT.LOSS_WEIGHTS_VMD[k] * v for k, v in losses.items())
        return total, (losses, new_state)

    fn = jax.value_and_grad(loss_fn, has_aux=True)
    (_, (losses, new_state)), grads = (jax.jit(fn)(params) if excess
                                       else written(fn, params))
    new_state = jax.tree.map(lambda a: a.astype(jnp.float32),
                             dict(new_state or {}))

    def port(tree):
        return {k: v.double().numpy() for k, v in jax_to_torch_state_dict(
            cfg.model, tree).items()}

    return ({k: float(v) for k, v in losses.items()},
            port({"params": grads}), port(new_state))


def _fba_jax_module():
    return JV.VMN(encoder=JF.FBAEncoder(layers=LAYERS),
                  decoder=JF.FBADecoderVMN(), fam_channels=256,
                  agg_window=WINDOW)


def _init_shapes(jmod, name):
    cin = 3 + TFM.TaskConfig(model=name).trimap_channels
    extras = ((jnp.zeros((1, 3, H, W, 3)), jnp.zeros((1, 3, H, W, 2)))
              if name == "vmn_fba" else None)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3, H, W, cin)),
        jnp.ones((1, 3, H, W, 1)), extras=extras, train=False))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module", params=["vmn_fba", "vmn_gca"])
def bf16_steps(request):
    """The same step from the same weights, batch (B = 1, S = 5) and
    radius: (name, {"port f32", "port bf16": (metrics, grads, after,
    before), "jax": JAX's bf16 step as written, "jax jit": JAX's bf16
    step under plain ``jit``, each (losses, grads, new state)})."""
    name = request.param
    port = build_model(name, agg_window=WINDOW, layers=LAYERS, device="cpu")
    cfg = TFM.TaskConfig(model=name, agg_window=WINDOW)
    if name == "vmn_gca":
        _prepare_gca(port, cfg)
        jmod = JR.build_model(name, agg_window=WINDOW)
    else:
        jmod = _fba_jax_module()
    variables = carried(name, _init_shapes(jmod, name), port)
    weights = port.state_dict()
    batch = _clip(5, 5)
    jcfg = JFM.TaskConfig(model=name, agg_window=WINDOW)
    radius = jax_radius(KEY, 1)
    out = {}
    for key, cd in (("port f32", None), ("port bf16", torch.bfloat16)):
        trainer = TT.MattingTrainer(cfg, "vmd", layers=LAYERS, device="cpu",
                                    compute_dtype=cd)
        out[key] = port_train_step(trainer, weights, batch, radius,
                                   torch.float32)
    out["jax"] = jax_step(jmod, variables, batch, jcfg, BF16)
    out["jax jit"] = jax_step(jmod, variables, batch, jcfg, BF16,
                              excess=True)
    return name, out


# rtol of the bf16 step's losses against JAX's: FBA's lie within 1.2e-5;
# GCA's within 2.1e-3 (L_att), since its sigmas are bf16 numbers from f32
# sums the frameworks add up in other orders, one that rounds the other
# way scales a layer by 2^-8, and its attention carries that on (JAX's own
# plain jit moves L_att by 1.0e-3, and its bf16 step lies 2.4e-3 from its
# f32 step)
BF16_LOSS_RTOL = {"vmn_fba": 1e-4, "vmn_gca": 3e-3}


def test_bf16_step_losses_match_jax(bf16_steps):
    """Each loss within ``BF16_LOSS_RTOL`` of JAX's bf16 step, or within
    twice what JAX's own two compilations of it differ by."""
    name, out = bf16_steps
    metrics = out["port bf16"][0]
    want, jit = out["jax"][0], out["jax jit"][0]
    for k, v in want.items():
        assert k in ("L2", "L3") or v > 0, k
        tol = max(BF16_LOSS_RTOL[name] * abs(v), 2 * abs(jit[k] - v))
        assert abs(metrics[k].item() - v) <= tol, (k, metrics[k].item(), v,
                                                  jit[k])


def test_bf16_step_gradients_match_jax(bf16_steps):
    """Each module's gradient (``module_errors``) within relative L2 of
    the larger of 2e-4 and twice what JAX's plain ``jit`` moves it from
    the step as written. A bf16 rounding sits on each weight, and an f32
    difference of the frameworks' sums that straddles one (FBA's
    weight standardization, GCA's sigma) moves it by 2^-8; the network
    carries that on: FBA's encoder gradients lie 2.6e-2 apart (1.2e-3 in
    f32), GCA's 0.5 (1e-2 in f32), and JAX's two compilations as far.
    For FBA the port's step is also 10x nearer JAX's bf16 step than its
    own f32 step (median module)."""
    name, out = bf16_steps
    got, want, jit = (out["port bf16"][1], out["jax"][1], out["jax jit"][1])
    errs, spread = module_errors(got, want), module_errors(jit, want)
    assert len(errs) > 30
    for m, e in errs.items():
        assert e <= max(2e-4, 2 * spread[m]), (m, e, spread[m])
    if name == "vmn_fba":
        recipe = module_errors(got, out["port f32"][1])
        assert (10 * np.median(list(errs.values()))
                <= np.median(list(recipe.values())))


def test_bf16_step_state_matches_jax(bf16_steps):
    """GCA's BatchNorm statistics after the bf16 step within 1 bf16 ulp
    of JAX's and its ``u`` and ``v`` within 2, at the buffer's scale (its
    largest element: a vector's small elements carry the rounding of its
    large ones; ``l2n`` rounds the norm and then each element), or
    within twice what JAX's plain ``jit`` moves them. FBA holds no
    state."""
    name, out = bf16_steps
    after = out["port bf16"][2]
    new, jit = out["jax"][2], out["jax jit"][2]
    assert bool(new) == (name == "vmn_gca")
    for k, want in new.items():
        scale = bf16_ulp(np.abs(want).max())
        err = np.abs(after[k].numpy() - want).max() / scale
        spread = np.abs(jit[k] - want).max() / scale
        ulps = 2.0 if k.endswith(("weight_u", "weight_v")) else 1.0
        assert err <= max(ulps, 2 * spread), (k, err, spread)


@pytest.mark.parametrize("name", ["vmn_dim", "vmn_index"])
def test_bf16_step_keeps_the_master_state_f32(name):
    """DIM's and IndexNet's bf16 steps (as JAX's ``tests/test_bf16_train.py``
    checks its own): the parameters, their gradients, Adam's moments and
    every floating buffer stay f32, and the losses are finite. (Their
    products' dtypes: ``test_bf16_dtype_map_matches_jax``.)"""
    b = 2 if name == "vmn_index" else 1
    batch = {k: torch.from_numpy(np.repeat(v[:, :3], b, axis=0))
             for k, v in _clip(5, 3).items()}
    trainer = TT.MattingTrainer(TFM.TaskConfig(model=name,
                                               agg_window=WINDOW),
                                "vmd", device="cpu",
                                compute_dtype=torch.bfloat16)
    state = trainer.init_state()
    state, metrics = trainer.train_step(state, batch,
                                        radius=torch.full((b,), 3))
    model, opt = state.model, state.optimizer
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        assert all(t.dtype == torch.float32 for k, t in opt.state[p].items()
                   if k != "step")
    assert all(t.dtype in (torch.float32, torch.int64)
               for t in model.buffers())
    assert all(np.isfinite(v.item()) for k, v in metrics.items()
               if k != "lr")
