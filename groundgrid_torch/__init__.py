"""groundgrid_torch: the GroundGrid engine in PyTorch, with CUDA kernels for Hopper.

A port of ``groundgrid_tpu`` (JAX/XLA/Pallas on a TPU), which stays in the
repository as the reference it is tested against. The port imports torch and
NumPy, never JAX or ``groundgrid_tpu``. It covers the streaming step in both
modes, sorted scans (host prep in f32 or the s16 wire format) and unsorted
raw scans (transform and cell sort on the device): grid move, f64-faithful
binning, outlier ray-march, sorted rasterization, patch detection (row-major
stencils, or the fused stencil under ``config.fused_detect``), spiral
interpolation, classification and, with ``with_aux``, the eleven published
grid layers; plus checkpoint / restore of the grid state in the JAX
package's format. Four hand-written CUDA kernels (``groundgrid_torch/ops``,
sources in ``groundgrid_torch/csrc``) are built by ``nvcc`` at first use.

Entry point: ``python -m groundgrid_torch evaluate | playback | accuracy |
bench`` (``runtime/cli.py``) over a SemanticKITTI-layout dataset, with the
C++ prefetching loaders (``data/native_loader.py``), the pipelined driver
and on-device scoring (``eval/device.py``); ``bench --batch B`` runs a fleet
of B vehicles in lock-step (``runtime/fleet.py``, ``parallel/``, the JAX
package's fleet axis over a device list and ``torch.distributed``);
``make_spatial_step`` splits one grid row-wise over a mesh of devices or
ranks (``parallel/spatial.py``, the spiral as an exact band relay). The
evidence tooling holds the port to its own copy of the NumPy oracle
(``golden.py``): the accuracy harness (``eval/accuracy.py``) and the config
fuzz (``python -m groundgrid_torch.eval.fuzz``).
"""

from groundgrid_torch.config import DEFAULT_CONFIG, HIGHRES_CONFIG, GroundGridConfig
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
    pad_scan,
    prepare_scan,
    prepare_scan_wire,
)
from groundgrid_torch.data.semantickitti import ScanRecord
from groundgrid_torch.runtime.checkpoint import load_state, save_state
from groundgrid_torch.runtime.driver import StreamingDriver
from groundgrid_torch.runtime.fleet import FleetDriver, FleetTickResult
from groundgrid_torch.parallel.sharding import FleetSummary, make_fleet_step, make_mesh
from groundgrid_torch.parallel.multihost import MultiHostFleet, init_multihost
from groundgrid_torch.parallel.spatial import (
    GroupMesh,
    LocalMesh,
    blocks_from_numpy,
    blocks_to_numpy,
    make_spatial_step,
    shard_scan,
)

__version__ = "0.1.0"

__all__ = [
    "GroundGridConfig",
    "DEFAULT_CONFIG",
    "HIGHRES_CONFIG",
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
    "pad_scan",
    "prepare_scan",
    "prepare_scan_wire",
    "save_state",
    "load_state",
    "ScanRecord",
    "StreamingDriver",
    "FleetDriver",
    "FleetTickResult",
    "FleetSummary",
    "make_fleet_step",
    "make_mesh",
    "MultiHostFleet",
    "init_multihost",
    "make_spatial_step",
    "LocalMesh",
    "GroupMesh",
    "shard_scan",
    "blocks_from_numpy",
    "blocks_to_numpy",
    "__version__",
]


_LAZY = {
    "SemanticKITTI": "groundgrid_torch.data.semantickitti",
    "Evaluator": "groundgrid_torch.eval.metrics",
    "DeviceEvaluator": "groundgrid_torch.eval.device",
    "SortedPrefetchingLoader": "groundgrid_torch.data.native_loader",
    "WirePrefetchingLoader": "groundgrid_torch.data.native_loader",
    "LiveServer": "groundgrid_torch.runtime.live",
    "run_accuracy_benchmark": "groundgrid_torch.eval.accuracy",
}


def __getattr__(name):
    # the data, evaluation and viewer entry points, imported on first use
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'groundgrid_torch' has no attribute {name!r}")
