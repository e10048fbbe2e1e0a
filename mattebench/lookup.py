"""How the benchmark finds what it is given by name.

Everything is found under a checkout's ``mattebench/`` folder (a cell's
``here``): a configuration's ``method`` names its reference model,
``reference/<method>.py``, and each name in its ``kernels`` the work of
a hand-written kernel, ``kernels/<kernel>.py``, both modules of this
package (:func:`package_module`, checked under ``here`` and then
imported); a traffic generator and a metric reader are loaded from their
files by path (:func:`load_module`). A name with no file refuses the
run, naming the file it looked for.
"""
from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Refused(Exception):
    """The run cannot give a result (printed, exit code not 0)."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).is_file():
        raise Refused(f"no module {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def package_module(folder: str, name: str, here: Path = HERE):
    """The module ``<here>/<folder>/<name>.py`` (``here`` is this
    package's folder unless a cell gives its own), imported."""
    path = Path(here) / folder / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise Refused(f"no module {path} for {folder} {name!r}")
    return importlib.import_module(f"mattebench.{folder}.{name}")
