"""PyTorch/CUDA port of tcvom_tpu (TCVOM video matting).

The JAX package ``tcvom_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``infer/``, ``utils/``) and adds ``csrc/``,
the hand-written CUDA kernels for Hopper (sm_90a). Networks run NCHW;
public functions keep the JAX package's channel-last layout.
"""
