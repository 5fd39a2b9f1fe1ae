"""groundgrid_torch: the GroundGrid engine in PyTorch, with CUDA kernels for Hopper.

A port of ``groundgrid_tpu`` (JAX/XLA/Pallas on a TPU), which stays in the
repository as the reference it is tested against. The port imports torch and
NumPy, never JAX or ``groundgrid_tpu``. It covers the sorted-scan streaming
step: host prep, grid move, f64-faithful binning, outlier ray-march, sorted
rasterization, patch detection, spiral interpolation and classification,
with three hand-written CUDA kernels (``groundgrid_torch/ops``, sources in
``groundgrid_torch/csrc``) built by ``nvcc`` at first use.
"""

from groundgrid_torch.config import DEFAULT_CONFIG, GroundGridConfig
from groundgrid_torch.core.grid import GridState, state_from_numpy, state_to_numpy
from groundgrid_torch.pipeline import (
    CenterTracker,
    Scan,
    StepOutput,
    init_state,
    make_step,
    make_step_fn,
    prepare_scan,
)
from groundgrid_torch.runtime.driver import ScanRecord, StreamingDriver

__version__ = "0.1.0"

__all__ = [
    "GroundGridConfig",
    "DEFAULT_CONFIG",
    "GridState",
    "state_from_numpy",
    "state_to_numpy",
    "Scan",
    "StepOutput",
    "CenterTracker",
    "init_state",
    "make_step",
    "make_step_fn",
    "prepare_scan",
    "ScanRecord",
    "StreamingDriver",
    "__version__",
]
