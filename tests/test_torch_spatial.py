"""The port's spatial axis (``parallel/spatial.py``) on an in-process CPU mesh.

``["cpu"] * 8`` mirrors the JAX tests' 8 virtual CPU devices. The sharded
detect is bitwise the port's single-grid detect and within the JAX
sharded detect's own bound of it; the spatial step agrees with the port's
single-grid step and with the JAX ``make_spatial_step`` on the 8-device mesh
within ``tests/test_spatial.py``'s bounds; the banded spiral gives bitwise
the replicated one; and ``__graft_entry__.py dryrun_multichip``'s checks
hold at its 32^2 configuration.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.parallel.spatial import make_sharded_detect as j_sharded_detect
from groundgrid_tpu.parallel.spatial import make_spatial_step as j_spatial_step
from groundgrid_tpu.parallel.spatial import spatial_sharding as j_spatial_sharding
from groundgrid_tpu.pipeline import init_state as j_init_state
from groundgrid_tpu.pipeline import make_step as j_make_step
from groundgrid_tpu.pipeline import pad_scan as j_pad_scan

import groundgrid_torch
from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import detect as detectlib
from groundgrid_torch.core import rasterize as rasterlib
from groundgrid_torch.core import scalars as scalarlib
from groundgrid_torch.data.synthetic import (adversarial_sequence, make_scene, render_scan,
                                             synthetic_sequence, vehicle_pose)
from groundgrid_torch.ops import raster as rasterops
from groundgrid_torch.parallel import spatial
from groundgrid_torch.parallel.sharding import (make_fleet_step, make_mesh, shard_fleet_pytree,
                                                stack_fleet_pytree)
from groundgrid_torch.pipeline import (CenterTracker, init_state, make_step, make_step_fn,
                                       pad_scan, prepare_scan)

torch.set_num_threads(1)

MESH = ["cpu"] * 8
# tests/test_spatial.py's 48^2 detect config and conftest.py's small_config
DETECT_KW = dict(dimension=24.0, resolution=0.5, max_points=4096, ray_steps=28,
                 max_outlier_candidates=256)
SMALL_KW = dict(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                max_outlier_candidates=1024)
# __graft_entry__.py dryrun_multichip's config
DRYRUN_KW = dict(dimension=16.0, resolution=0.5, max_points=1024, ray_steps=24,
                 max_outlier_candidates=128, sorted_scans=True)
LABELS_MIN = 0.9995


def _detect_inputs(n, seed=0):
    """tests/test_spatial.py's random detect layers."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(3, (n, n)).astype(np.float32)
    variance = np.abs(rng.normal(0, 1e-3, (n, n))).astype(np.float32)
    min_gh = rng.normal(0, 0.5, (n, n)).astype(np.float32)
    min_gh[counts == 0] = np.float32(np.finfo(np.float32).max)
    ground = rng.normal(0, 0.5, (n, n)).astype(np.float32)
    conf = rng.uniform(0, 1, (n, n)).astype(np.float32)
    return counts, variance, min_gh, ground, conf


def test_sharded_detect_bitwise_and_within_jax():
    cfg, jcfg = GroundGridConfig(**DETECT_KW), JConfig(**DETECT_KW)
    arrays = _detect_inputs(cfg.cell_count)
    full = [torch.from_numpy(a) for a in arrays]
    want = detectlib.detect_ground_patches(cfg, detectlib.make_tables(cfg, "cpu"), *full)
    f = spatial.make_sharded_detect(cfg, MESH)
    got = f(*[spatial.split_rows(t, MESH) for t in full])
    got = [torch.cat(blocks) for blocks in got]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[1] != full[4]).sum()) > 100  # the sweep changes cells

    mesh = Mesh(np.array(jax.devices()), ("space",))
    sh = j_spatial_sharding(mesh)
    jg, jc = j_sharded_detect(jcfg, mesh)(*[jax.device_put(jnp.asarray(a), sh) for a in arrays])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jg), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jc), atol=1e-6)


def test_halo_quirk_touches_no_output():
    """The grid-edge halo rows are zeros for the minimum too (+inf pads the
    whole grid's windows): the 5x5 minimum of rows 0-1 and N-2..N-1 sees
    them, but those rows lie outside ``tables.interior``, so the edge
    shards' outputs equal those of a +inf halo."""
    cfg = GroundGridConfig(**DETECT_KW)
    n = cfg.cell_count
    arrays = [torch.from_numpy(a) for a in _detect_inputs(n, seed=4)]
    arrays[2] = 1.0 + arrays[2].abs().clamp_max(5.0)  # above the zero halo: minima differ
    tables = detectlib.make_tables(cfg, "cpu")
    for s, rows in ((0, slice(0, 6)), (7, slice(n - 6, n))):
        blocks = [spatial.exchange_halo(spatial.split_rows(t, MESH), MESH)[s] for t in arrays[:3]]
        h = detectlib.HALO
        edge = slice(0, h) if s == 0 else slice(-h, None)
        assert not blocks[2][edge].any()  # zero-filled, not +inf
        inf_halo = blocks[2].clone()
        inf_halo[edge] = float("inf")
        zero_min = detectlib._minpool(blocks[2], 5)[h:-h]
        inf_min = detectlib._minpool(inf_halo, 5)[h:-h]
        differs = (zero_min != inf_min).nonzero()[:, 0].unique().tolist()
        assert differs and set(differs) <= ({0, 1} if s == 0 else {4, 5})
        tabs = detectlib.row_tables(tables, rows)
        assert not tabs.interior[sorted(differs)].any()
        g, c = arrays[3][rows], arrays[4][rows]
        zero_out = detectlib.detect_block(cfg, tabs, blocks[0], blocks[1], blocks[2], g, c)
        inf_out = detectlib.detect_block(cfg, tabs, blocks[0], blocks[1], inf_halo, g, c)
        assert torch.equal(zero_out[0], inf_out[0]) and torch.equal(zero_out[1], inf_out[1])


def test_indivisible_grid_and_points_raise():
    with pytest.raises(ValueError, match="not divisible"):
        spatial.make_sharded_detect(GroundGridConfig(**dict(DETECT_KW, dimension=24.5,
                                                            ray_steps=30)), MESH)
    with pytest.raises(ValueError, match="not divisible"):
        spatial.make_spatial_step(GroundGridConfig(**dict(DETECT_KW, dimension=24.5,
                                                          ray_steps=30)), MESH)
    with pytest.raises(ValueError, match="max_points 4100 not divisible"):
        spatial.make_spatial_step(GroundGridConfig(**dict(DETECT_KW, max_points=4100)), MESH)
    with pytest.raises(ValueError, match="with_scan_center"):
        spatial.make_spatial_step(GroundGridConfig(**dict(DETECT_KW, sorted_scans=True)), MESH)


def test_cuda_mesh_without_cuda_raises(monkeypatch):
    """A mesh that names a card raises where there is none: no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GroundGridConfig(**DETECT_KW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spatial.make_spatial_step(cfg, ["cuda:0"] * 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spatial.make_sharded_detect(cfg, ["cuda:0"] * 8)


def _binned(cfg, pts, lbl, T):
    """A cell-sorted scan of ``pts`` with its binning and accepted points."""
    tracker = CenterTracker(cfg, np.asarray(T, np.float64)[:2, 3])
    scan, _ = prepare_scan(cfg, pts, lbl, T, tracker.update(np.asarray(T)[:2, 3]), "cpu")
    s = scalarlib.host(cfg, scan.center, scan.center_lo, scan.t_map_velo, scan.t_map_base,
                       scan.t_base_map)
    binning = rasterlib.bin_points(cfg, s, scan.px, scan.py, scan.rings, scan.valid > 0)
    return scan, s, binning, binning.inmap & ~binning.ignored


@pytest.mark.parametrize("with_max", [False, True])
def test_raster_partials_fold(with_max):
    """One shard's partials finish bitwise as ``rasterize_sorted``; four
    chunks of the same sorted points fold to the same counts and extrema
    bitwise, and the sums within rounding."""
    cfg = GroundGridConfig(**dict(SMALL_KW, sorted_scans=True))
    pts, lbl, T = next(iter(synthetic_sequence(1, seed=7, n_beams=24, n_azimuth=720)))
    scan, s, binning, accept = _binned(cfg, pts, lbl, T)
    reduce_fn = rasterops.raster_reduce
    want = rasterlib.rasterize_sorted(cfg, binning, scan.pz, accept, s, reduce_fn,
                                      with_max=with_max)
    part = rasterlib.raster_partials(cfg, binning, scan.pz, accept, s, reduce_fn)
    one = rasterlib.finish_partials(cfg, [part], s, with_max=with_max)
    for a, b in zip(one, want):
        assert torch.equal(a, b)
    k = cfg.max_points // 4
    parts = [rasterlib.raster_partials(cfg, binning.permute(slice(i * k, (i + 1) * k)),
                                       scan.pz[i * k:(i + 1) * k], accept[i * k:(i + 1) * k], s,
                                       reduce_fn) for i in range(4)]
    four = rasterlib.finish_partials(cfg, parts, s, with_max=with_max)
    for name in ("points", "points_raw", "min_ground_height", "max_ground_height"):
        assert torch.equal(getattr(four, name), getattr(want, name)), name
    for name in ("ground_candidates", "plane_dist", "m2", "variance"):
        torch.testing.assert_close(getattr(four, name), getattr(want, name), atol=1e-6,
                                   rtol=1e-5)


def _jax_put(scan, pt_sh, rep_sh):
    return jax.tree.map(lambda a: jax.device_put(
        np.asarray(a), pt_sh if np.asarray(a).ndim == 1 else rep_sh), scan)


def _gathered(blocks):
    return torch.cat(blocks).numpy()


def test_spatial_step_matches_single_grid_and_jax():
    """``tests/test_spatial.py``'s case: small_config (80^2), 3 synthetic
    scans, unsorted, centers on the device. The port's spatial step on
    ``["cpu"] * 8`` against the port's single-grid step (the eager one, which
    steps center-less scans) and against the JAX
    ``make_spatial_step`` on the 8-device mesh: labels >= 99.95 %, ground
    atol 2e-4 / rtol 1e-4, confidence 1e-5 / 1e-5."""
    cfg, jcfg = GroundGridConfig(**SMALL_KW), JConfig(**SMALL_KW)
    step1, step_s = make_step_fn(cfg), spatial.make_spatial_step(cfg, MESH)
    mesh = Mesh(np.array(jax.devices()), ("space",))
    j_step = j_spatial_step(jcfg, mesh)
    grid_sh, pt_sh, rep_sh = (j_spatial_sharding(mesh), NamedSharding(mesh, P("space")),
                              NamedSharding(mesh, P()))
    state = None
    agree = {"single": 0, "jax": 0}
    total = 0
    for pts, lbl, T in synthetic_sequence(3, seed=5, n_beams=16, n_azimuth=500):
        scan = pad_scan(cfg, pts, lbl, T, "cpu")
        jscan = j_pad_scan(jcfg, pts, lbl, T)
        if state is None:
            state = init_state(cfg, np.asarray(T, np.float32), "cpu")
            jst = j_init_state(jcfg, np.asarray(T, np.float32))
            g, c, center = spatial.blocks_from_numpy(*[np.asarray(a) for a in jst], MESH)
            jg, jc = (jax.device_put(np.asarray(a), grid_sh) for a in (jst.ground,
                                                                      jst.groundpatch))
            jcenter = jax.device_put(np.asarray(jst.center), rep_sh)
            assert torch.equal(torch.cat(g), state.ground) and torch.equal(center[0],
                                                                           state.center)
        state, out = step1(state, scan)
        g, c, center, labels, outlier = step_s(g, c, center, spatial.shard_scan(scan, MESH))
        jg, jc, jcenter, jlabels, _ = j_step(jg, jc, jcenter, _jax_put(jscan, pt_sh, rep_sh))
        assert torch.equal(center[0], state.center) and torch.equal(center[1], state.center_lo)
        np.testing.assert_array_equal(center[0].numpy(), np.asarray(jcenter))
        for ref_g, ref_c in ((state.ground.numpy(), state.groundpatch.numpy()),
                             (np.asarray(jg), np.asarray(jc))):
            np.testing.assert_allclose(_gathered(g), ref_g, atol=2e-4, rtol=1e-4)
            np.testing.assert_allclose(_gathered(c), ref_c, atol=1e-5, rtol=1e-5)
        lab = torch.cat(labels).numpy()
        assert lab.shape == (cfg.max_points,)
        total += lab.size
        agree["single"] += int((lab == out.labels.numpy()).sum())
        agree["jax"] += int((lab == np.asarray(jlabels)).sum())
        assert torch.equal(torch.cat(outlier), out.outlier)
    for name, n_agree in agree.items():
        assert n_agree / total >= LABELS_MIN, f"vs {name}: {n_agree} of {total} labels agree"


@pytest.mark.parametrize("use_pallas", [None, False], ids=["wrappers", "plain"])
def test_banded_equals_replicated(use_pallas):
    """``tests/test_spatial.py``'s adversarial case: the banded relay and the
    replicated sweep give the same labels, outliers and layers, bitwise."""
    cfg = GroundGridConfig(**dict(SMALL_KW, use_pallas=use_pallas))
    step_r = spatial.make_spatial_step(cfg, MESH, spiral_mode="replicated")
    step_b = spatial.make_spatial_step(cfg, MESH, spiral_mode="banded")
    sr = sb = None
    for pts, lbl, T in adversarial_sequence(2, seed=9, n_beams=16, n_azimuth=500):
        scan = pad_scan(cfg, pts, lbl, T, "cpu")
        if sr is None:
            st = init_state(cfg, np.asarray(T, np.float32), "cpu")
            blocks = (spatial.split_rows(st.ground, MESH), spatial.split_rows(st.groundpatch, MESH),
                      (st.center, st.center_lo))
            sr = sb = blocks
        chunks = spatial.shard_scan(scan, MESH)
        *sr, lab_r, out_r = step_r(*sr, chunks)
        *sb, lab_b, out_b = step_b(*sb, chunks)
        for a, b in ((sr[0], sb[0]), (sr[1], sb[1]), (lab_r, lab_b), (out_r, out_b)):
            assert torch.equal(torch.cat(a), torch.cat(b))
        assert torch.equal(sr[2][0], sb[2][0])
    assert (torch.cat(lab_r) == 99).sum() > 0 and (torch.cat(lab_r) == 49).sum() > 0


def test_dryrun_multichip_checks():
    """``__graft_entry__.py dryrun_multichip`` at its 32^2 config over 8
    shards: the fleet == each vehicle's single step, bitwise; the spatial
    step with the banded spiral labels as the single-grid step, its grids
    within 2e-4 (ground) and 1e-5 (confidence)."""
    cfg = GroundGridConfig(**DRYRUN_KW)
    scene = make_scene(0, extent=20.0)
    scans, states = [], []
    for k in range(8):
        pose = vehicle_pose(scene, k)
        pts, lbl = render_scan(scene, pose, n_beams=8, n_azimuth=96, max_range=10.0, seed=k)
        tracker = CenterTracker(cfg, pose[:2, 3].astype(np.float32))
        scan, _ = prepare_scan(cfg, pts, lbl, pose, tracker.update(pose[:2, 3]), "cpu")
        scans.append(scan)
        states.append(init_state(cfg, pose.astype(np.float32), "cpu"))

    devices = make_mesh(MESH)
    fleet = make_fleet_step(cfg, devices)
    fleet_states = shard_fleet_pytree(stack_fleet_pytree(
        [dataclasses.replace(s, ground=s.ground.clone(), groundpatch=s.groundpatch.clone())
         for s in states]), devices)
    fleet_states, outs, summary = fleet(fleet_states, shard_fleet_pytree(
        stack_fleet_pytree(scans), devices))
    assert int(summary.ground_points) + int(summary.nonground_points) > 0
    step1 = make_step(cfg)
    singles = []
    for k in range(8):
        st, out = step1(dataclasses.replace(states[k], ground=states[k].ground.clone(),
                                            groundpatch=states[k].groundpatch.clone()), scans[k])
        # the captured step's layers are static: the next call overwrites them
        st = dataclasses.replace(st, ground=st.ground.clone(), groundpatch=st.groundpatch.clone())
        singles.append((st, out))
        assert torch.equal(outs[k].labels[0], out.labels)
        assert torch.equal(fleet_states[k].ground[0], st.ground)
        assert torch.equal(fleet_states[k].groundpatch[0], st.groundpatch)

    step_s = spatial.make_spatial_step(cfg, MESH, spiral_mode="banded", with_scan_center=True)
    st0 = states[0]
    g, c, center, labels, _ = step_s(spatial.split_rows(st0.ground, MESH),
                                     spatial.split_rows(st0.groundpatch, MESH),
                                     (st0.center, st0.center_lo),
                                     spatial.shard_scan(scans[0], MESH))
    ref, ref_out = singles[0]
    lab = torch.cat(labels)
    assert int((lab > 0).sum()) > 0
    assert torch.equal(lab, ref_out.labels)
    assert float((torch.cat(g) - ref.ground).abs().max()) <= 2e-4
    assert float((torch.cat(c) - ref.groundpatch).abs().max()) <= 1e-5


def test_state_round_trip_from_jax():
    """A JAX ``GridState`` (as NumPy arrays, after a step) split into the
    port's row blocks and gathered back, bitwise."""
    jcfg = JConfig(**DETECT_KW)
    pts, lbl, T = next(iter(synthetic_sequence(1, seed=3, n_beams=8, n_azimuth=256)))
    jstate, _ = j_make_step(jcfg)(j_init_state(jcfg, np.asarray(T, np.float32)),
                                  j_pad_scan(jcfg, pts, lbl, T))
    arrays = [np.asarray(a) for a in (jstate.ground, jstate.groundpatch, jstate.center,
                                      jstate.center_lo)]
    for mesh in (MESH, ["cpu"] * 2):
        g, c, center = spatial.blocks_from_numpy(*arrays, mesh)
        assert len(g) == len(mesh) and g[0].shape == (arrays[0].shape[0] // len(mesh),
                                                       arrays[0].shape[1])
        back = spatial.blocks_to_numpy(g, c, center, mesh)
        for a, b in zip(back, arrays):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        spatial.blocks_from_numpy(*arrays, ["cpu"] * 5)


def test_spatial_sources_import_no_jax():
    """Neither spatial module names ``jax`` or ``groundgrid_tpu`` in an import."""
    root = pathlib.Path(groundgrid_torch.__file__).parent / "parallel"
    pattern = re.compile(r"^\s*(import|from)\s+(jax|groundgrid_tpu)\b", re.M)
    for name in ("spatial.py", "spiral_shard.py"):
        assert not pattern.search((root / name).read_text()), name
