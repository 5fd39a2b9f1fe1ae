"""groundgrid_torch: the GroundGrid engine in PyTorch, with CUDA kernels for Hopper.

A port of ``groundgrid_tpu`` (JAX/XLA/Pallas on a TPU), which stays in the
repository as the reference it is tested against. The port imports torch and
NumPy, never JAX or ``groundgrid_tpu``. It covers the sorted-scan streaming
step: host prep (f32 or the s16 wire format), grid move, f64-faithful
binning, outlier ray-march, sorted rasterization, patch detection (row-major
stencils, or the fused stencil under ``config.fused_detect``), spiral
interpolation, classification and, with ``with_aux``, the eleven published
grid layers; plus checkpoint / restore of the grid state in the JAX
package's format. Four hand-written CUDA kernels (``groundgrid_torch/ops``,
sources in ``groundgrid_torch/csrc``) are built by ``nvcc`` at first use.
"""

from groundgrid_torch.config import DEFAULT_CONFIG, GroundGridConfig
from groundgrid_torch.core.grid import GridState, state_from_numpy, state_to_numpy
from groundgrid_torch.pipeline import (
    AuxLayers,
    CenterTracker,
    Scan,
    StepOutput,
    WireScan,
    init_state,
    make_step,
    make_step_fn,
    make_wire_step,
    prepare_scan,
    prepare_scan_wire,
)
from groundgrid_torch.runtime.checkpoint import load_state, save_state
from groundgrid_torch.runtime.driver import ScanRecord, StreamingDriver

__version__ = "0.1.0"

__all__ = [
    "GroundGridConfig",
    "DEFAULT_CONFIG",
    "GridState",
    "state_from_numpy",
    "state_to_numpy",
    "Scan",
    "WireScan",
    "StepOutput",
    "AuxLayers",
    "CenterTracker",
    "init_state",
    "make_step",
    "make_step_fn",
    "make_wire_step",
    "prepare_scan",
    "prepare_scan_wire",
    "save_state",
    "load_state",
    "ScanRecord",
    "StreamingDriver",
    "__version__",
]
