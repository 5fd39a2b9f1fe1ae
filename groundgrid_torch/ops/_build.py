"""Build and load the port's CUDA kernels (``groundgrid_torch/csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``csrc/`` into one shared
library with a plain C interface in ``groundgrid_torch/_build/`` (listed in
``.gitignore``), which is then loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o _build/libgroundgrid_kernels_<hash>.so csrc/*.cu

The file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing library. ``--fmad=false``
keeps every ``a*b+c`` separately rounded, as the plain PyTorch versions
round it: the spiral's confidence is held bitwise, and its decay test
``d2 > min_dist_squared`` hangs on the last ulp.

No C++ of PyTorch is included, so a build takes seconds. A failed build or
load raises; there is no fallback. Each C entry point returns
``cudaGetLastError()`` after its launch and :func:`check` raises on nonzero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every entry point ends with the CUDA stream and returns the
# launch's cudaGetLastError() code
_SIGNATURES = {
    "gg_raster_reduce": [_P, _P, _I, _I, ctypes.c_uint, _I, _P, _P],
    "gg_lookup": [_P, _I, _P, _P, _I, _P, _P, _P],
    "gg_spiral": [_P, _P, _I, _I, _F, _F, _F, _F, _F, _I, _I, _P],
    "gg_spiral_global": [_P, _P, _I, _I, _F, _F, _F, _F, _F, _I, _I, _P, _P],
    "gg_detect": [_P] * 9 + [_I, _F, _F, _F, _P, _P, _P],
}


class _Library:
    """The loaded kernel library plus its build time (0.0 when cached)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds


_loaded: _Library | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if the hashed library is missing); return its path."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"libgroundgrid_kernels_{_digest(sources)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def library() -> _Library:
    """Build (at first use) and load the kernel library."""
    global _loaded
    if _loaded is None:
        t0 = time.perf_counter()
        path = build()
        seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded = _Library(lib, path, seconds)
    return _loaded


def check(code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
