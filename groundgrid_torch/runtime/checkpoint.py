"""Checkpoint / resume of the streaming grid state.

The JAX package's ``.npz`` format v2 (``groundgrid_tpu/runtime/checkpoint.py``),
unchanged: arrays ``ground``, ``groundpatch`` (N, N) f32, ``center``,
``center_lo`` (2,) f32 and ``center64`` (2,) f64, plus a ``meta`` JSON string
with the format version, the next scan index, the grid geometry and any
extra fields. A checkpoint written by either package loads in the other.

The state is a pure function of (state, scans), so state(t) plus scans
t+1.. reproduce the uninterrupted run bitwise
(``StreamingDriver.restore``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core.grid import GridState, state_from_numpy, state_to_numpy

_FORMAT_VERSION = 2


def save_state(path: str, state: GridState, next_scan_index: int, config: GroundGridConfig,
               extra: Optional[dict] = None, center64=None) -> None:
    """Write the grid state and stream position to ``path`` (atomic rename).

    ``center64``: the driver's exact (2,) f64 tracker center
    (``StreamingDriver.center64``); without it ``center + center_lo`` is
    stored.
    """
    ground, groundpatch, center, center_lo = state_to_numpy(state)
    meta = dict(
        version=_FORMAT_VERSION,
        next_scan_index=int(next_scan_index),
        config={k: getattr(config, k) for k in ("dimension", "resolution", "max_points")},
        extra=extra or {},
    )
    if center64 is None:
        center64 = center.astype(np.float64) + center_lo.astype(np.float64)
    tmp = path + ".tmp.npz"  # np.savez appends .npz to other names
    np.savez(tmp, ground=ground, groundpatch=groundpatch, center=center, center_lo=center_lo,
             center64=np.asarray(center64, np.float64), meta=json.dumps(meta))
    os.replace(tmp, path)


def load_state(path: str, config: GroundGridConfig, device):
    """``(state, next_scan_index, extra)`` from ``path``, layers on ``device``.

    Raises if the checkpoint's grid geometry is not ``config``'s. ``extra``
    holds the saved extra fields and, in format v2, ``center64``.
    """
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["meta"]))
        if meta["version"] not in (1, _FORMAT_VERSION):
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        saved = meta["config"]
        if (saved["dimension"], saved["resolution"]) != (config.dimension, config.resolution):
            raise ValueError(
                f"checkpoint grid {saved['dimension']}m/{saved['resolution']}m "
                f"!= config {config.dimension}m/{config.resolution}m"
            )
        center_lo = f["center_lo"] if "center_lo" in f.files else None
        state = state_from_numpy(f["ground"], f["groundpatch"], f["center"], center_lo, device)
        extra = meta.get("extra", {})
        if "center64" in f.files:
            extra = dict(extra, center64=np.asarray(f["center64"], np.float64))
        return state, int(meta["next_scan_index"]), extra
