"""Build the CUDA sources in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` into ``build/kernels/lib<name>-<hash>.so`` at the repo root
(the hash covers the source and the flags, so an edited source rebuilds).
The build is lazy: the first wrapper call that needs a kernel builds it;
:func:`build` starts several ``nvcc`` processes at once.

Every C entry takes its pointers and the stream as ``void*`` and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
``LAUNCHES`` counts kernel launches by name: each wrapper adds one where it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Counter = Counter()
BUILD_LOG: dict[str, dict] = {}     # name -> {"seconds", "output", "cached"}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in " + str(CSRC))
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, dict]:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes at once; raise with the compiler output if one fails.
    A missing source raises before any ``nvcc`` starts, and an error while
    they run kills them: no compiler outlives the call."""
    libs = {name: library_path(name) for name in names}
    procs = {}
    failed = []
    try:
        for name, lib in libs.items():
            if lib.exists():
                BUILD_LOG.setdefault(name, {"seconds": 0.0, "output": "",
                                            "cached": True})
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           tmp, lib, time.perf_counter())
        for name, (proc, tmp, lib, t0) in procs.items():
            output, _ = proc.communicate()
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                               "output": output, "cached": False}
            if proc.returncode:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{output}")
            else:
                os.replace(tmp, lib)
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_LOG[n] for n in names}


def load_library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
