"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects link into one shared library with a
plain C interface, loaded with ctypes. The build runs at first use into
``build/torch_kernels/<hash>/`` under the repository root and is reused
until the hash of the sources and flags changes. Nothing here runs at
import time: the module imports on a host without ``nvcc`` or a card, and
only the first CUDA launch needs them.

Every kernel has a launch count in ``launches``, which its wrapper raises
by one where it launches the kernel and nowhere else, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libdiscogan_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> count of launches
launches = {"batch_stats": 0, "bn_act": 0, "conv_k4s2p1": 0,
            "conv_k4s2p1_dw": 0, "halo_conv_k4s2p1": 0,
            "halo_conv_k4s2p1_dw": 0, "head_convt": 0, "pipe_probe": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# Each kernel entry ends in the pair axis (pairs, then each operand's pair
# stride) and the stream; the read probe P has no pair axis.
_SIGNATURES = {
    "discogan_batch_stats": (_I, [_P] * 5 + [_LL] + [_I] * 8 + [_LL, _I, _I]
                             + [_I, _LL, _P]),
    "discogan_bn_act": (_I, [_P, _P, _P, _P, _LL] + [_I] * 8 + [_I] + [_LL] * 3 + [_P]),
    "discogan_conv_k4s2p1": (_I, [_P] * 7 + [_I] * 17 + [_I] + [_LL] * 3 + [_P]),
    "discogan_conv_k4s2p1_dw": (_I, [_P, _P, _P, _P] + [_I] * 14 + [_I, _LL, _LL, _P]),
    "discogan_halo_conv_k4s2p1_dw": (_I, [_P, _P, _P, _P] + [_I] * 14
                                     + [_I, _LL, _LL, _P]),
    "discogan_halo_conv_k4s2p1": (_I, [_P] * 5 + [_I] * 14 + [_I] + [_LL] * 3 + [_P]),
    "discogan_head_convt": (_I, [_P, _P, _P] + [_I] * 14 + [_LL] + [_I, _LL, _LL, _P]),
    "discogan_pipe_probe": (_I, [_P, _P, _P, _LL, _LL] + [_I] * 4 + [_LL, _I, _P]),
}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/`` into the shared library if its hash is new, and
    return the library's path. The per-source compiler output (registers,
    shared memory, spills from ``-Xptxas -v``) is kept in ``build.log``
    beside it."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _digest(sources)
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in (s for s in sources if s.suffix == ".cu"):
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def check_cuda_tensor(name: str, t: torch.Tensor, dtype=None, ndim=None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of a
    kernel dtype. The kernels load operands 16 bytes at a time, so a view
    at an odd storage offset is refused rather than given a slower path."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is None and t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: tensor must be 16-byte aligned (a view at "
                         "an odd storage offset; pass .clone())")


def workspace(n_floats: int, like: torch.Tensor) -> torch.Tensor | None:
    """An f32 scratch buffer of ``n_floats`` on ``like``'s device, or None."""
    if not n_floats:
        return None
    return torch.empty(n_floats, dtype=torch.float32, device=like.device)


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, fn, *args) -> None:
    """Call one C entry point, raise on its CUDA error, count the launch."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
    launches[kernel] += 1
