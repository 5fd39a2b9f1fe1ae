"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips when ``torch.cuda.is_available()`` is false
(decided inside the ``cuda`` fixture, never at import). This file imports
neither JAX nor ``groundgrid_tpu``, so on a machine without JAX it runs
alone:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

Small sizes, including grids below 32 cells a side: K1 bitwise on every
column, K2 bitwise, K3 confidence bitwise and heights within atol 2e-5 /
rtol 1e-5; plus the small-config streaming step on the card against the
same step on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.ops import launch_counts, lookup, raster, reset_launch_counts, spiral

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _sorted_cells(rng, p, n2):
    return np.sort(rng.integers(0, n2 + 1, p)).astype(np.int32)


@pytest.mark.parametrize("n,p", [(5, 77), (31, 3000), (80, 16384), (364, 131072)])
def test_raster_kernel_matches_plain(cuda, n, p):
    rng = np.random.default_rng(n)
    n2 = n * n
    cell = torch.from_numpy(_sorted_cells(rng, p, n2)).to(cuda)
    cols = [torch.from_numpy(rng.standard_normal(p).astype(np.float32)).to(cuda)
            for _ in range(7)]
    cols[0] = (cols[0] > 0).float()
    ops = ["sum"] * 5 + ["min", "max"]
    before = raster.raster_reduce.launches
    got = raster.raster_reduce(cell, cols, ops, n2)
    assert raster.raster_reduce.launches == before + 1
    want = raster.raster_reduce_plain(cell, cols, ops, n2)
    torch.cuda.synchronize()
    for j, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"column {j}"


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "overflow", "empty"])
def test_lookup_kernel_matches_plain(cuda, kind):
    rng = np.random.default_rng(3)
    n2 = 80 * 80
    cell = {"sorted": _sorted_cells(rng, 16384, n2),
            "unsorted": rng.integers(0, n2 + 1, 37888).astype(np.int32),
            "overflow": np.full(4096, n2, np.int32),
            "empty": np.zeros(0, np.int32)}[kind]
    cell = torch.from_numpy(cell).to(cuda)
    words = rng.integers(0, 1 << 32, n2, dtype=np.uint64).astype(np.uint32).view(np.float32)
    tabs = [torch.from_numpy(words).to(cuda),
            torch.from_numpy(rng.standard_normal((80, 80)).astype(np.float32)).to(cuda)]
    for k in (1, 2):
        got = lookup.lookup(cell, tabs[:k], n2)
        want = lookup.lookup_plain(cell, tabs[:k], n2)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("dimension,resolution", [(12.0, 0.5), (15.0, 0.5), (40.0, 0.5),
                                                  (70.0, 0.5), (120.0, 0.33)])
def test_spiral_kernel_matches_plain(cuda, dimension, resolution):
    cfg = GroundGridConfig(dimension=dimension, resolution=resolution)
    n = cfg.cell_count
    rng = np.random.default_rng(n)
    ground = torch.from_numpy(rng.normal(0, 0.5, (n, n)).astype(np.float32)).to(cuda)
    conf = np.zeros((n, n), np.float32)
    mask = rng.random((n, n)) < 0.4
    conf[mask] = rng.uniform(0.0, 1.0, mask.sum())
    conf = torch.from_numpy(conf).to(cuda)
    g_k, c_k = spiral.spiral_interpolation(cfg, ground.clone(), conf.clone(), 0.37)
    g_p, c_p = spiral.spiral_interpolation_plain(cfg, ground.clone(), conf.clone(), 0.37)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_p)
    torch.testing.assert_close(g_k, g_p, atol=2e-5, rtol=1e-5)
    with pytest.raises(ValueError):  # the kernel writes in place: no strided views
        spiral.spiral_interpolation(cfg, ground.t(), conf.t(), 0.37)


def test_wrappers_reject_bad_input(cuda):
    cell = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        lookup.lookup(cell, [torch.zeros(4, device=cuda)], 4)
    with pytest.raises(ValueError):
        raster.raster_reduce(cell.int(), [torch.zeros(8, device=cuda)], ["mean"], 4)
    cfg = GroundGridConfig(dimension=12.0, resolution=0.5)
    with pytest.raises(ValueError):
        spiral.spiral_interpolation(cfg, torch.zeros(3, 3, device=cuda),
                                    torch.zeros(3, 3, device=cuda), 0.0)


def test_small_step_on_card_matches_cpu(cuda):
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.runtime.driver import ScanRecord, StreamingDriver

    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                           max_outlier_candidates=1024, sorted_scans=True)
    scans = list(synthetic_sequence(3, seed=7, n_beams=24, n_azimuth=720, step_m=1.5))
    recs = [ScanRecord(index=i, timestamp=0.1 * i, points=p, labels=l, t_map_velo=T)
            for i, (p, l, T) in enumerate(scans)]
    cpu, gpu = StreamingDriver(cfg, device="cpu"), StreamingDriver(cfg, device=cuda)
    reset_launch_counts()
    total = mism = 0
    for rec in recs:
        a, b = cpu.process(rec), gpu.process(rec)
        total += a.labels.size
        mism += int((a.labels != b.labels).sum())
    assert launch_counts() == {"raster": 3, "lookup": 9, "spiral": 3}
    assert mism <= 0.001 * total
    assert gpu.step.fallbacks == 0
    np.testing.assert_array_equal(gpu.state.center.numpy(), cpu.state.center.numpy())
    plain = StreamingDriver(dataclasses.replace(cfg, use_pallas=False), device=cuda)
    reset_launch_counts()
    for rec in recs:
        plain.process(rec)
    assert launch_counts() == {"raster": 0, "lookup": 0, "spiral": 0}
