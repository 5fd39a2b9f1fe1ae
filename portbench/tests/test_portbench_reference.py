"""The reference is the algorithm: it agrees with the repository's
sequential NumPy oracle (the node's formulas, point by point and cell by
cell) on labels, outliers and layers over moving sequences, and its
vectorized spiral with the node's walk on random layers."""

import dataclasses

import numpy as np
import pytest
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import transforms as tf
from groundgrid_torch.data.synthetic import adversarial_sequence, synthetic_sequence
from groundgrid_torch.golden import GoldenGroundGrid, GoldenState
from portbench.reference.groundgrid import Geometry, GroundGridReference, RingPlan


def chain_depth(g: Geometry, d: int) -> int:
    """How deep the reads of cells another side-walk of ring ``d`` wrote
    chain, walked visit by visit as the node walks them."""
    m = g.m
    lo, hi = m - d, m + d
    walks = [[(lo, y) for y in range(lo, lo + 2 * d)], [(x, lo) for x in range(lo, lo + 2 * d)],
             [(hi, y) for y in range(hi, hi - 2 * d - 1, -1)],
             [(x, hi) for x in range(hi, hi - 2 * d - 1, -1)]]
    last, depth, t, top = {}, {}, 0, 0
    for walk in walks:
        for k, (x, y) in enumerate(walk):
            dep = 0
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    c = (x + dx, y + dy)
                    if c in last:
                        if k > 0 and last[c] == t - 1:
                            dep = max(dep, depth[t - 1])
                        else:
                            dep = max(dep, depth[last[c]] + 1)
            depth[t], last[(x, y)] = dep, t
            top, t = max(top, dep), t + 1
    return top


def test_ring_solves_cover_the_deepest_chain():
    g = Geometry({"dimension": 60.0, "resolution": 0.5, "min_dist_squared": 12.0})
    assert max(chain_depth(g, d) for d in range(1, g.m)) + 1 == RingPlan.ITERATIONS


@pytest.mark.parametrize("dim, res", [(8.0, 0.5), (12.0, 0.33), (20.0, 0.2)])
def test_spiral_matches_the_walk(dim, res):
    cfg = GroundGridConfig(dimension=dim, resolution=res, min_dist_squared=1.0)
    n = cfg.cell_count
    rng = np.random.default_rng(n)
    g0 = rng.normal(size=(n, n)).astype(np.float32)
    c0 = rng.uniform(0, 1, size=(n, n)).astype(np.float32)
    c0[rng.uniform(size=(n, n)) < 0.2] = 1.0
    gold = GoldenGroundGrid(cfg)
    gold.state = GoldenState(g0.copy(), c0.copy(), np.zeros(2))
    pose = np.eye(4)
    pose[2, 3] = 0.7
    gold._spiral_interpolation(pose)
    ref = GroundGridReference(dataclasses.asdict(cfg), 2, "cpu")
    ref.ground = torch.from_numpy(np.stack([g0, -g0]))
    ref.groundpatch = torch.from_numpy(np.stack([c0, c0]))
    ref._spiral(torch.tensor([0.7, 0.7]))
    np.testing.assert_allclose(ref.ground[0].numpy(), gold.state.ground, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ref.groundpatch[0].numpy(), gold.state.groundpatch)


@pytest.mark.parametrize("sequence", [synthetic_sequence, adversarial_sequence])
def test_sequence_matches_the_oracle(sequence):
    cfg = GroundGridConfig(dimension=30.0, resolution=0.5, max_points=8192, ray_steps=32)
    gold = GoldenGroundGrid(cfg)
    ref = GroundGridReference(dataclasses.asdict(cfg), 1, "cpu")
    outliers = 0
    for i, (pts, lbl, T) in enumerate(sequence(5, seed=4, n_beams=16, n_azimuth=480,
                                               step_m=1.5)):
        mv, mb, bm = tf.scan_poses(T)
        x, y, z = tf.transform_points_soa(np.asarray(mv), pts[:, 0], pts[:, 1], pts[:, 2])
        gold.update_odom(np.asarray(T, np.float64), np.asarray(bm, np.float64))
        want = gold.filter_cloud(np.stack([x, y, z], -1), lbl, np.asarray(mv[:3, 3]),
                                 np.asarray(mb, np.float64))
        p = torch.zeros(1, cfg.max_points, 3)
        r = torch.zeros(1, cfg.max_points, dtype=torch.int32)
        p[0, :len(pts)] = torch.from_numpy(pts)
        r[0, :len(pts)] = torch.from_numpy(lbl)
        if i == 0:
            ref.reset(T[None])
        labels, outlier = ref.step(p, r, [len(pts)], T[None])
        np.testing.assert_array_equal(labels[0, :len(pts)].numpy(), want)
        assert sorted(np.nonzero(outlier[0].numpy())[0]) == sorted(gold.last_outliers)
        outliers += len(gold.last_outliers)
        np.testing.assert_allclose(ref.ground[0].numpy(), gold.state.ground, atol=5e-5)
        np.testing.assert_allclose(ref.groundpatch[0].numpy(), gold.state.groundpatch,
                                   atol=1e-6)
        np.testing.assert_array_equal(ref.center[0], gold.state.center)
    if sequence is adversarial_sequence:
        assert outliers > 0  # the march found something to flag


def test_capped_march_sheds_as_the_configuration_states():
    """Past ``max_outlier_candidates`` the reference marches the same
    candidates the port does (witness: the port's plain step on the CPU)."""
    from groundgrid_torch import ScanRecord, StreamingDriver

    cfg = GroundGridConfig(dimension=30.0, resolution=0.5, max_points=8192, ray_steps=32,
                           max_outlier_candidates=24)
    driver = StreamingDriver(cfg, "cpu")
    ref = GroundGridReference(dataclasses.asdict(cfg), 1, "cpu")
    capped = 0
    for i, (pts, lbl, T) in enumerate(adversarial_sequence(6, seed=2, n_beams=16,
                                                           n_azimuth=480, step_m=1.5)):
        res = driver.process(ScanRecord(i, 0.1 * i, pts, lbl, T))
        capped += driver.step.marchable > cfg.max_outlier_candidates
        p = torch.zeros(1, cfg.max_points, 3)
        r = torch.zeros(1, cfg.max_points, dtype=torch.int32)
        p[0, :len(pts)] = torch.from_numpy(pts)
        r[0, :len(pts)] = torch.from_numpy(lbl)
        if i == 0:
            ref.reset(T[None])
        labels, outlier = ref.step(p, r, [len(pts)], T[None])
        np.testing.assert_array_equal(outlier[0, :len(pts)].numpy(), res.outlier)
        np.testing.assert_array_equal(labels[0, :len(pts)].numpy(), res.labels)
    assert capped >= 3
