"""The work of the program's hand-written kernels, one module a kernel,
found by the names in a configuration's ``kernels``
(``mattebench/kernels/<kernel>.py``), whatever implements the function.

Each module has ``work(program, encodes, frames_decoded)``: ``[bytes,
operations, peak]`` of ``encodes`` steps' encodes and the decodes of the
clip frames ``frames_decoded`` (every stream's), from the run's
``program.config``, ``program.traffic`` and ``program.params``, held to
``counts.bound_s``. A module may also have ``flop_per_matte(program)``:
the FLOP of a matte that the kernel computes and that the count over the
reference model (``counts.flop_per_frame``) does not see; ``step_mfu``
adds them.
"""
