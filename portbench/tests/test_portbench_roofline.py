"""The frozen byte counts give PERF.md section 6's "Bound ms" at 3.35 TB/s:
K3 0.0006 ms at 364^2, 0.0069 at 1200^2, 0.0401 for 64 grids at 364^2;
K1 0.0022 on phase 2's scan (131,072-point buffer, 116,286 points inside
the grid: its 7.49 MB) and 0.1431 for 64 such scans."""

import numpy as np
import pytest

from portbench import roofline


def ms(n_bytes):
    return roofline.bound_s(n_bytes) * 1e3


@pytest.mark.parametrize("n, grids, want", [(364, 1, 0.0006), (1200, 1, 0.0069),
                                            (364, 64, 0.0401)])
def test_k3_bound(n, grids, want):
    assert round(ms(roofline.k3_bytes(n) * grids), 4) == want


@pytest.mark.parametrize("scans, want", [(1, 0.0022), (64, 0.1431)])
def test_k1_bound(scans, want):
    assert round(ms(roofline.k1_bytes(131072, 116286, 364) * scans), 4) == want


def test_k3_bytes_count_the_walk():
    # rings 0 .. m-1 written, 0 .. m read, both f32 layers: 364^2 is 2.10 MB
    assert roofline.k3_bytes(364) == 8 * (361 ** 2 + 363 ** 2)
    assert abs(roofline.k3_bytes(364) / 1e6 - 2.10) < 0.005


def test_drive_centers_snap_half_away_from_zero():
    poses = np.tile(np.eye(4), (3, 1, 1, 1))
    poses[1, 0, 0, 3] = 0.25  # exactly half a 0.5 m cell
    poses[2, 0, 0, 3] = -0.2  # 1.4 cells back
    c = roofline.drive_centers(poses, 0.5)
    assert c[1, 0, 0] == 0.5 and c[2, 0, 0] == 0.0
