"""Build and load the port's CUDA kernels (``groundgrid_torch/csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``csrc/``, one process
per source, all started together, and links the objects into one shared
library with a plain C interface in ``groundgrid_torch/_build/`` (listed in
``.gitignore``), which is then loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -c -o <tmp>/<source>.o csrc/<source>.cu   (each source)
    nvcc -shared -o _build/libgroundgrid_kernels_<hash>.so <tmp>/*.o

The file name carries a hash of the sources, the headers beside them
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one loads the existing library. ``--fmad=false`` keeps every
``a*b+c`` separately rounded, as the plain PyTorch versions round it: the
spiral's confidence is held bitwise, and its decay test ``d2 >
min_dist_squared`` hangs on the last ulp; the binning, the march and the
raster stage and the grid move (``binning.cu``, ``march.cu``,
``raster_stage.cu``, ``move.cu``) round each step with the ``_rn``
intrinsics of ``exactf32.cuh`` besides.

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
    "--fmad=false", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every entry point but a query ends with the CUDA stream and
# returns the launch's cudaGetLastError() code
_SIGNATURES = {
    "gg_raster_reduce": [_P, _P, _I, _I, _I, ctypes.c_uint, _I, _P, _P],
    "gg_lookup": [_P, _I, _I, _P, _P, _I, ctypes.c_longlong, _P, _P, _P],
    "gg_spiral": [_P, _P, _I, _I, _P, _I, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _P],
    "gg_spiral_global": [_P, _P, _I, _I, _P, _F, _F, _F, _F, _I, _I, _I, _I, _I, _P, _P],
    "gg_detect": [_P] * 9 + [_I, _I, _F, _F, _F, _P, _P, _I, _P],
    "gg_detect_stage": [_P] * 6 + [_I] * 4 + [_F] * 4 + [_P, _P, _P],
    "gg_bin": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _F, _F, _F, _I, _F] + [_P] * 7,
    "gg_march_budget": [_P] * 6 + [_I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P],
    "gg_march": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _F, _F, _F, _F, _F, _I, _P,
                 _P],
    "gg_raster_columns": [_P] * 6 + [_I, _I, _I, _P, _I, _F, _P, _P, _P],
    "gg_raster_finish": [_P, _I, _I, _I, _P, _I, _F, _I, _P, _P],
    "gg_select": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "gg_select_cluster": [_I, _I],  # a query: no stream
    "gg_move": [_P, _P, _I, _I, _P, _I, _F, _F, _P, _P, _P],
    "gg_stamp": [_P, _P, _I, _I, _I, _I, _P],
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
    """The hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC.glob("*.cuh")):
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, src.stem + ".o") for src in sources]
        jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in jobs]
        try:
            outputs = [proc.communicate() for proc in procs]
        finally:
            for proc in procs:  # none outlives the build
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for cmd, proc, (stdout, stderr) in zip(jobs, procs, outputs):
            _check_nvcc(cmd, proc.returncode, stdout, stderr)
        lib = os.path.join(tmp, out.name)
        link = [nvcc, "-shared", "-o", lib, *objects]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, proc.returncode, proc.stdout, proc.stderr)
        os.replace(lib, out)  # atomic: a concurrent build never sees a partial file
    return out


def _check_nvcc(cmd, returncode, stdout, stderr) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}")


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


def launch(entry: str, device, *args) -> int:
    """Call the C entry point ``entry`` with ``args`` and PyTorch's current
    stream on ``device``, with ``device`` made the current device: a ctypes
    call launches on the current device, and the default stream's handle
    (0) names the current device's. Returns the entry's error code."""
    import torch

    with torch.cuda.device(device):
        return getattr(library().lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
