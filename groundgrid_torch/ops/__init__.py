"""Hand-written CUDA kernels of the port, each beside its plain version.

K1 ``raster.raster_reduce``, K2 ``lookup.lookup``, K3
``spiral.spiral_interpolation`` (its ring-band kernel, or the global-band
one above 2415 cells a side), K4 ``detect.detect_fused``: the ports of the
JAX package's Pallas kernels. K5 ``binning.bin_points``, K6
``march.march_budget``, K7 ``march.march``, K8
``detect_stage.detect_stage``, K9 ``raster_stage.raster_columns_ordered``,
K10 ``raster_stage.finish_layers``, K11 ``select.select_candidates`` and
K12 ``move.move``: the ports of what XLA fuses of its binning, occlusion
march, detect stage, raster stage, candidate selection and grid move. Each wrapper
counts its kernel launches in a ``launches`` attribute (K3 counts either
variant there, and the global-band one also in ``global_launches``);
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes them.
A step captured as a CUDA graph (``pipeline.CapturedStep``) launches its
kernels by replaying it: it takes the counts its capture recorded
(:func:`counter_values` before and after) off again, and adds them on each
replay (:func:`add_launches`), so the counters still count per scan.
"""

from __future__ import annotations

import functools


def _wrappers():
    from groundgrid_torch.ops.binning import bin_points
    from groundgrid_torch.ops.detect import detect_fused
    from groundgrid_torch.ops.detect_stage import detect_stage
    from groundgrid_torch.ops.lookup import lookup
    from groundgrid_torch.ops.march import march, march_budget
    from groundgrid_torch.ops.move import move
    from groundgrid_torch.ops.raster import raster_reduce
    from groundgrid_torch.ops.raster_stage import finish_layers, raster_columns_ordered
    from groundgrid_torch.ops.select import select_candidates
    from groundgrid_torch.ops.spiral import spiral_interpolation

    return {"raster": raster_reduce, "lookup": lookup, "spiral": spiral_interpolation,
            "detect": detect_fused, "bin": bin_points, "march_budget": march_budget,
            "march": march, "raster_columns": raster_columns_ordered,
            "raster_finish": finish_layers, "select": select_candidates, "move": move,
            "detect_stage": detect_stage}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["spiral"].global_launches = 0


@functools.cache
def _counters():
    """(wrapper, attribute) of every launch counter, built once."""
    wrappers = _wrappers()
    return tuple([(fn, "launches") for fn in wrappers.values()]
                 + [(wrappers["spiral"], "global_launches")])


def counter_values() -> tuple[int, ...]:
    """Every launch counter, in a fixed order (for :func:`set_counters`)."""
    return tuple(getattr(fn, attr) for fn, attr in _counters())


def set_counters(values) -> None:
    for (fn, attr), v in zip(_counters(), values):
        setattr(fn, attr, v)


def add_launches(delta) -> None:
    """Add ``delta`` (a difference of two :func:`counter_values`) to the counters."""
    for (fn, attr), d in zip(_counters(), delta):
        setattr(fn, attr, getattr(fn, attr) + d)
