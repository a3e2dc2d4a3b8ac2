"""Text-patched variants of the port's CUDA sources for the A/B tools
(``conv_ab``, ``head_ab``, ``fused_ab``, ``halo_ab``, ``dw_ab``): each
variant a copy of csrc/ with its source patched, built alone into its own
library by one nvcc (all started at once), and its C entry loaded with
ctypes under the signature the wrapper's entry has (ops/_build.py
``_SIGNATURES``).

``start`` launches the builds and returns at once, so that a caller can
overlap them with other work (chip_smoke.py starts them beside its kernel
checks), at the lowest CPU priority so that the work they overlap keeps
its cores; ``load`` waits for them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path


def _lowest_priority() -> None:
    os.nice(19)


def start(variants: dict, out: Path) -> dict:
    """One nvcc a variant, all started now: ``variants`` maps a name to
    (its csrc/ file, its (old, new) text patches, each old matching the
    source once); each builds under ``out``. Returns ``load``'s argument."""
    from ..ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    started = {}
    for i, (name, (source, patches)) in enumerate(variants.items()):
        text = (_build.CSRC / source).read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch does not match the source once: {old}")
            text = text.replace(old, new)
        d = Path(out) / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / source).write_text(text)
        started[name] = (d, subprocess.Popen(
            [_build._nvcc(), *flags, "-shared", str(d / source), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=_lowest_priority))
    return started


def load(started: dict, entry) -> dict:
    """Wait for ``start``'s builds; name -> its library's C entry ``entry``
    (a name, or a function of the variant's name), typed as
    ``_build._SIGNATURES`` says. Raises with nvcc's output where a build
    failed."""
    from ..ops import _build

    fns = {}
    for name, (d, proc) in started.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        symbol = entry(name) if callable(entry) else entry
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), symbol)
        fn.restype, fn.argtypes = _build._SIGNATURES[symbol]
        fns[name] = fn
    return fns
