"""JAX variables -> the port's ``state_dict``.

The port's module names are the reference PyTorch ``state_dict`` keys, so
the JAX package's own converter (``convert_state_dict``) reads a port
``state_dict`` back; this module goes the other way, so weights carry across
in both directions. Layout: HWIO -> OIHW for conv kernels, ``scale`` ->
``weight`` for norms; BatchNorm's ``batch_stats`` ``mean`` and ``var`` ->
``running_mean`` and ``running_var``; a spectral-norm conv's
``kernel_bar`` -> ``module.weight_bar`` (HW(in)(out) -> IOHW for a
transposed one) and its ``spectral`` ``u`` and ``v`` ->
``module.weight_u`` and ``module.weight_v``. ``num_batches_tracked`` has
no JAX counterpart: the module keeps its own (load with ``strict=False``).
"""
from __future__ import annotations

import re

import numpy as np
import torch

# (regex on the JAX module path "a/b/c", torch module-name template)
_FBA_RULES = [
    (r"^encoder/conv1$", r"encoder.conv1"),
    (r"^encoder/bn1$", r"encoder.bn1"),
    (r"^encoder/(layer\d)_(\d+)/(conv[123]|bn[123])$", r"encoder.\1.\2.\3"),
    (r"^encoder/(layer\d)_(\d+)/ds_conv$", r"encoder.\1.\2.downsample.0"),
    (r"^encoder/(layer\d)_(\d+)/ds_bn$", r"encoder.\1.\2.downsample.1"),
    (r"^decoder/ppm/pool(\d)_conv$", r"decoder.ppm.\1.1"),
    (r"^decoder/ppm/pool(\d)_bn$", r"decoder.ppm.\1.2"),
    (r"^decoder/up1_0_conv$", r"decoder.conv_up1.0"),
    (r"^decoder/up1_0_bn$", r"decoder.conv_up1.1"),
    (r"^decoder/up1_1_conv$", r"decoder.conv_up1.3"),
    (r"^decoder/up1_1_bn$", r"decoder.conv_up1.4"),
    (r"^decoder/up2_conv$", r"decoder.conv_up2.0"),
    (r"^decoder/up2_bn$", r"decoder.conv_up2.1"),
    (r"^decoder/up3_conv$", r"decoder.conv_up3.0"),
    (r"^decoder/up3_bn$", r"decoder.conv_up3.1"),
    (r"^decoder/up4_0$", r"decoder.conv_up4.0"),
    (r"^decoder/up4_1$", r"decoder.conv_up4.2"),
    (r"^decoder/up4_2$", r"decoder.conv_up4.4"),
    (r"^fam/(key|query|value)_conv$", r"decoder.fam.\1_conv"),
]


def _dim_rules(vmn: bool) -> list[tuple[str, str]]:
    """The inverse of tcvom_tpu/utils/convert.py::_dim_rules: the
    single-frame DIM's keys have no ``encoder.``/``decoder.`` prefix."""
    enc, dec = ("encoder.", "decoder.") if vmn else ("", "")
    return [
        (r"^encoder/block(\d)(\d)/(conv|bn)$", enc + r"\3\1\2"),
        (r"^encoder/conv6$", enc + "conv6"),
        (r"^decoder/(dconv\d|alpha_pred)$", dec + r"\1"),
        (r"^fam/(key|query|value)_conv$", r"decoder.fam.\1_conv"),
    ]


_IR_SLOTS = {"1": {"dw": 0, "dw_bn": 1, "pw_linear": 3, "pw_linear_bn": 4},
             "[2-7]": {"pw": 0, "pw_bn": 1, "dw": 3, "dw_bn": 4,
                       "pw_linear": 6, "pw_linear_bn": 7}}


def _index_rules() -> list[tuple[str, str]]:
    """The inverse of tcvom_tpu/utils/convert.py::_index_rules."""
    pp = r"^encoder/dconv_pp/"
    aspp = r"encoder.dconv_pp.aspp\1.atrous_conv."
    rules = [
        (r"^encoder/layer0/conv$", "encoder.layer0.0"),
        (r"^encoder/layer0/bn$", "encoder.layer0.1"),
        (r"^encoder/index(\d)/indexnet(\d)_conv0$",
         r"encoder.index\1.indexnet\2.0"),
        (r"^encoder/index(\d)/indexnet(\d)_bn$",
         r"encoder.index\1.indexnet\2.1"),
        (r"^encoder/index(\d)/indexnet(\d)_conv1$",
         r"encoder.index\1.indexnet\2.3"),
        (pp + r"aspp(1)_conv$", aspp + "0"),
        (pp + r"aspp(1)_bn$", aspp + "1"),
        (pp + r"aspp([234])_dw$", aspp + "0"),
        (pp + r"aspp([234])_dw_bn$", aspp + "1"),
        (pp + r"aspp([234])_pw$", aspp + "3"),
        (pp + r"aspp([234])_pw_bn$", aspp + "4"),
        (pp + r"global_conv$", "encoder.dconv_pp.global_avg_pool.1"),
        (pp + r"global_bn$", "encoder.dconv_pp.global_avg_pool.2"),
        (pp + r"bottleneck_conv$", "encoder.dconv_pp.bottleneck_conv.0"),
        (pp + r"bottleneck_bn$", "encoder.dconv_pp.bottleneck_conv.1"),
        (r"^decoder/(decoder_layer\d)/dconv/conv$", r"decoder.\1.dconv.0"),
        (r"^decoder/(decoder_layer\d)/dconv/bn$", r"decoder.\1.dconv.1"),
        (r"^decoder/pred/p0/conv$", "decoder.pred.0.0"),
        (r"^decoder/pred/p0/bn$", "decoder.pred.0.1"),
        (r"^decoder/pred/p1$", "decoder.pred.1"),
        (r"^fam/(key|query|value)_conv$", r"decoder.fam.\1_conv"),
    ]
    # the inverted residuals' Sequential indices: expand ratio 1 in layer1
    # (no expanding 1x1), 6 in the others
    rules += [(rf"^encoder/layer({layers})_(\d+)/{name}$",
               rf"encoder.layer\1.\2.conv.{j}")
              for layers, slots in _IR_SLOTS.items()
              for name, j in slots.items()]
    return rules


def _gca_rules() -> list[tuple]:
    """The inverse of tcvom_tpu/utils/convert.py::_gca_rules, for ``gca``
    and ``vmn_gca`` alike; a third element marks a spectral-norm conv
    (``"sn"``) or a transposed one (``"sn_t"``): the leaf names do not
    tell them apart."""
    blk = r"^encoder/(layer\d|layer_bottleneck)_(\d+)/"
    rules = [
        (r"^encoder/conv([123])$", r"encoder.conv\1", "sn"),
        (r"^encoder/bn([123])$", r"encoder.bn\1"),
        (blk + r"(conv[12])$", r"encoder.\1.\2.\3", "sn"),
        (blk + r"(bn[12])$", r"encoder.\1.\2.\3"),
        (blk + r"ds_conv$", r"encoder.\1.\2.downsample.1", "sn"),
        (blk + r"ds_bn$", r"encoder.\1.\2.downsample.2"),
        (r"^encoder/shortcut(\d)/conv1$", r"encoder.shortcut.\1.0", "sn"),
        (r"^encoder/shortcut(\d)/bn1$", r"encoder.shortcut.\1.2"),
        (r"^encoder/shortcut(\d)/conv2$", r"encoder.shortcut.\1.3", "sn"),
        (r"^encoder/shortcut(\d)/bn2$", r"encoder.shortcut.\1.5"),
        (r"^(encoder|decoder)/gca/guidance_conv$", r"\1.gca.guidance_conv"),
        (r"^(encoder|decoder)/gca/W_conv$", r"\1.gca.W.0"),
        (r"^(encoder|decoder)/gca/W_bn$", r"\1.gca.W.1"),
        # the first block of each decoder layer upsamples: transposed conv1
        (r"^decoder/(layer\d)_(0)/(conv1)$", r"decoder.\1.\2.\3", "sn_t"),
        (r"^decoder/(layer\d)_(\d+)/(conv[12])$", r"decoder.\1.\2.\3",
         "sn"),
        (r"^decoder/(layer\d)_(\d+)/(bn[12])$", r"decoder.\1.\2.\3"),
        (r"^decoder/(layer\d)_(\d+)/up_conv$", r"decoder.\1.\2.upsample.1",
         "sn"),
        (r"^decoder/(layer\d)_(\d+)/up_bn$", r"decoder.\1.\2.upsample.2"),
        (r"^decoder/conv1$", "decoder.conv1", "sn_t"),
        (r"^decoder/(bn1|conv2)$", r"decoder.\1"),
        (r"^fam/(key|query|value)_conv$", r"decoder.fam.\1_conv"),
    ]
    # the guidance head's Sequential: (pad, conv, ReLU, BatchNorm) x 3
    for i in range(3):
        rules += [(rf"^encoder/guidance{i}$",
                   f"encoder.guidance_head.{4 * i + 1}", "sn"),
                  (rf"^encoder/guidance_bn{i}$",
                   f"encoder.guidance_head.{4 * i + 3}")]
    return rules


_RULES = {"vmn_fba": _FBA_RULES, "dim": _dim_rules(False),
          "vmn_dim": _dim_rules(True), "index": _index_rules(),
          "vmn_index": _index_rules(), "gca": _gca_rules(),
          "vmn_gca": _gca_rules()}


def _hwio_to_oihw(a):
    return np.transpose(a, (3, 2, 0, 1))


def _sn_leaves(kernel_tf) -> dict:
    return {"params": {"kernel_bar": ("module.weight_bar", kernel_tf)},
            "spectral": {"u": ("module.weight_u", None),
                         "v": ("module.weight_v", None)}}


# rule kind -> collection -> leaf -> (torch name, transform)
_LEAVES = {
    None: {
        "params": {
            "kernel": ("weight", _hwio_to_oihw),
            "scale": ("weight", None),
            "bias": ("bias", None),
        },
        "batch_stats": {"mean": ("running_mean", None),
                        "var": ("running_var", None)},
    },
    "sn": _sn_leaves(_hwio_to_oihw),
    # HW(in)(out) -> IOHW, the inverse of the JAX converter's _tconv_w
    "sn_t": _sn_leaves(lambda a: np.transpose(a, (2, 3, 0, 1))),
}


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def jax_to_torch_state_dict(model_name: str, variables: dict
                            ) -> dict[str, torch.Tensor]:
    """Convert the JAX package's variables (nested dicts of arrays: the
    ``params`` collection and, for BatchNorm, ``batch_stats``, for
    spectral norm, ``spectral``) to the port's ``state_dict``. Raises on
    any leaf it cannot place."""
    if model_name not in _RULES:
        raise ValueError(f"unknown model {model_name!r}")
    rules = [(re.compile(rule[0]), rule[1], rule[2] if len(rule) > 2 else None)
             for rule in _RULES[model_name]]
    out: dict[str, torch.Tensor] = {}
    for coll, tree in variables.items():
        for path, val in _flatten(tree):
            module, leaf = path.rsplit("/", 1)
            for pat, tmpl, kind in rules:
                m = pat.match(module)
                leaves = _LEAVES[kind].get(coll, {})
                if m and leaf in leaves:
                    name, tf = leaves[leaf]
                    arr = np.asarray(val, dtype=np.float32)
                    out[f"{m.expand(tmpl)}.{name}"] = torch.tensor(
                        tf(arr) if tf else arr)
                    break
            else:
                raise KeyError(f"no port parameter for JAX leaf {coll}/{path}")
    return out
