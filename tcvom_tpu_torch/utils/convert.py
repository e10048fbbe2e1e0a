"""JAX variables -> the port's ``state_dict``.

The port's module names are the reference PyTorch ``state_dict`` keys, so
the JAX package's own converter (``convert_state_dict``) reads a port
``state_dict`` back; this module goes the other way, so weights carry across
in both directions. Layout: HWIO -> OIHW for conv kernels, ``scale`` ->
``weight`` for norms.
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

_LEAVES = {
    "kernel": ("weight", lambda a: np.transpose(a, (3, 2, 0, 1))),  # HWIO->OIHW
    "scale": ("weight", None),
    "bias": ("bias", None),
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
    """Convert the JAX package's variables (nested dicts of arrays, with a
    ``params`` collection) to the port's ``state_dict``. Raises on any
    leaf it cannot place."""
    if model_name != "vmn_fba":
        raise NotImplementedError(
            f"{model_name!r} is not ported yet: ROADMAP.md Queue 1 item 10")
    rules = [(re.compile(p), t) for p, t in _FBA_RULES]
    out: dict[str, torch.Tensor] = {}
    for path, val in _flatten(variables["params"]):
        module, leaf = path.rsplit("/", 1)
        for pat, tmpl in rules:
            m = pat.match(module)
            if m and leaf in _LEAVES:
                name, tf = _LEAVES[leaf]
                arr = np.asarray(val, dtype=np.float32)
                out[f"{m.expand(tmpl)}.{name}"] = torch.tensor(
                    tf(arr) if tf else arr)
                break
        else:
            raise KeyError(f"no port parameter for JAX leaf {path}")
    return out
