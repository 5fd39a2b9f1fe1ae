"""Hand-written CUDA kernels of the port, each beside its plain version.

K1 ``raster.raster_reduce``, K2 ``lookup.lookup``, K3
``spiral.spiral_interpolation``, K4 ``detect.detect_fused``. Each wrapper
counts its kernel launches in a ``launches`` attribute; :func:`launch_counts`
reads them and :func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations


def _wrappers():
    from groundgrid_torch.ops.detect import detect_fused
    from groundgrid_torch.ops.lookup import lookup
    from groundgrid_torch.ops.raster import raster_reduce
    from groundgrid_torch.ops.spiral import spiral_interpolation

    return {"raster": raster_reduce, "lookup": lookup, "spiral": spiral_interpolation,
            "detect": detect_fused}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
