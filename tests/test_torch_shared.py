"""The port's copies of framework-free pieces equal the JAX package's originals.

``groundgrid_torch`` cannot import ``groundgrid_tpu`` (that imports JAX), so
it carries copies of the config dataclass, the host transforms, the detect
tables' expected-points table, the synthetic scan generator, the label table,
the host scorer and its baseline comparison, the SemanticKITTI reader and
writer, and the viewers' image and terrain exports. These tests hold each
copy to its original: same fields and defaults, bitwise outputs, the same
text and bytes.
"""

import dataclasses

import numpy as np
import pytest

import groundgrid_tpu.config as jconfig
import groundgrid_tpu.core.transforms as jtf
import groundgrid_tpu.data.synthetic as jsyn
from groundgrid_tpu.golden import expected_points_table as j_expected

import groundgrid_torch.config as tconfig
import groundgrid_torch.core.transforms as ttf
import groundgrid_torch.data.synthetic as tsyn
from groundgrid_torch.core.detect import expected_points_table as t_expected


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults():
    assert _fields(tconfig.GroundGridConfig) == _fields(jconfig.GroundGridConfig)


@pytest.mark.parametrize("name", ["DEFAULT_CONFIG", "HIGHRES_CONFIG"])
def test_config_constants(name):
    """The exported configurations, field by field; HIGHRES_CONFIG is the
    1200^2 grid (120 m at 0.1 m)."""
    import groundgrid_torch

    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert getattr(groundgrid_torch, name) is t
    for f in dataclasses.fields(jconfig.GroundGridConfig):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.cell_count, t.half_length, t.center_cell) == (
        j.cell_count, j.half_length, j.center_cell)
    if name == "HIGHRES_CONFIG":
        assert t.cell_count == 1200


@pytest.mark.parametrize("kw", [
    {},
    {"dimension": 40.0, "resolution": 0.5, "max_points": 16384, "ray_steps": 40},
    {"resolution": 0.1},
    {"dimension": 70.0, "resolution": 0.5},
])
def test_config_geometry(kw):
    j, t = jconfig.GroundGridConfig(**kw), tconfig.GroundGridConfig(**kw)
    assert (t.cell_count, t.half_length, t.center_cell) == (
        j.cell_count, j.half_length, j.center_cell)
    assert t.validate() is t


@pytest.mark.parametrize("kw", [
    {"dimension": 2.0},
    {"max_points": 0},
    {"resolution": float("nan")},
    {"wire_format": True},
])
def test_config_validate_rejects_alike(kw):
    with pytest.raises(ValueError):
        jconfig.GroundGridConfig(**kw).validate()
    with pytest.raises(ValueError):
        tconfig.GroundGridConfig(**kw).validate()


def test_transforms_bitwise():
    rng = np.random.default_rng(0)
    for _ in range(5):
        yaw, pitch = rng.uniform(-3, 3), rng.uniform(-0.2, 0.2)
        cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
        T = np.eye(4)
        T[:3, :3] = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]) @ np.array(
            [[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        T[:3, 3] = rng.normal(0, 500, 3)
        for a, b in zip(ttf.scan_poses(T), jtf.scan_poses(T)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ttf.invert_rigid(T), jtf.invert_rigid(T))
        pts = rng.normal(0, 30, (1000, 3))
        np.testing.assert_array_equal(ttf.transform_points(T, pts), jtf.transform_points(T, pts))


@pytest.mark.parametrize("kw", [{}, {"dimension": 40.0, "resolution": 0.5}])
def test_expected_points_table_bitwise(kw):
    np.testing.assert_array_equal(
        t_expected(tconfig.GroundGridConfig(**kw)), j_expected(jconfig.GroundGridConfig(**kw)))


def test_scene_and_poses_bitwise():
    a, b = tsyn.make_scene(3, extent=200.0), jsyn.make_scene(3, extent=200.0)
    for f in dataclasses.fields(jsyn.Scene):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)), err_msg=f.name)
    xs = np.linspace(-50, 150, 101)
    np.testing.assert_array_equal(tsyn.terrain_z(a, xs, 0.3 * xs), jsyn.terrain_z(b, xs, 0.3 * xs))
    for k in (0, 7, 31):
        np.testing.assert_array_equal(tsyn.vehicle_pose(a, k, step_m=1.2),
                                      jsyn.vehicle_pose(b, k, step_m=1.2))


def test_render_scan_bitwise():
    a, b = tsyn.make_scene(0), jsyn.make_scene(0)
    T = jsyn.vehicle_pose(b, 4, step_m=1.2)
    pa, la = tsyn.render_scan(a, T, n_beams=16, n_azimuth=400, seed=4)
    pb, lb = jsyn.render_scan(b, T, n_beams=16, n_azimuth=400, seed=4)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(la, lb)


def test_synthetic_sequence_bitwise():
    kw = dict(seed=7, n_beams=24, n_azimuth=720, step_m=1.5)
    for (pa, la, Ta), (pb, lb, Tb) in zip(tsyn.synthetic_sequence(3, **kw),
                                          jsyn.synthetic_sequence(3, **kw)):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(Ta, Tb)


@pytest.mark.parametrize("kw", [
    {},
    {"dimension": 40.0, "resolution": 0.5},
    {"dimension": 12.0, "resolution": 0.5},
    {"dimension": 300.0, "resolution": 0.2},
    {"dimension": 70.0, "resolution": 0.37},
])
def test_wire_scales_bitwise(kw):
    from groundgrid_tpu.pipeline import wire_scales as j_scales

    from groundgrid_torch.pipeline import wire_scales as t_scales

    a = t_scales(tconfig.GroundGridConfig(**kw))
    b = j_scales(jconfig.GroundGridConfig(**kw))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_port_imports_no_jax():
    """``groundgrid_torch`` and every module of it import in a fresh
    interpreter without pulling in ``jax`` or ``groundgrid_tpu``."""
    import pathlib
    import subprocess
    import sys

    import groundgrid_torch

    root = pathlib.Path(groundgrid_torch.__file__).parent
    modules = sorted(
        "groundgrid_torch." + ".".join(p.relative_to(root).with_suffix("").parts)
        for p in root.rglob("*.py") if p.name != "__init__.py"
    )
    assert "groundgrid_torch.ops.detect" in modules and len(modules) > 15
    code = (
        "import importlib, sys\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'groundgrid_tpu'))\n"
        "assert not bad, ('imported at startup', bad)\n"
        "sys.modules.update(jax=None, groundgrid_tpu=None)  # importing either now raises\n"
        f"for m in {['groundgrid_torch', *modules]!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root.parent, timeout=300)
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stderr


def test_labels_table():
    import groundgrid_tpu.data.labels as jl

    import groundgrid_torch.data.labels as tl

    assert tl.LABELS == jl.LABELS and tl.MAX_LABEL_ID == jl.MAX_LABEL_ID
    for name in ("GROUND_IDS", "ADDITIONAL_GROUND_IDS", "NON_GROUND_IDS", "ALL_GROUND_IDS"):
        assert getattr(tl, name) == getattr(jl, name), name


def _random_clouds(seed, n_clouds=3, n=5000):
    rng = np.random.default_rng(seed)
    ids = [0, 10, 40, 44, 48, 49, 50, 51, 60, 70, 72, 80, 252, 300]
    return [(rng.choice([0, 49, 99], n, p=[0.05, 0.75, 0.2]).astype(np.int32),
             rng.choice(ids, n).astype(np.int32)) for _ in range(n_clouds)]


def test_evaluator_counts_metrics_and_text():
    """Counts, metrics, the reference's statistics block and the checkpoint
    state: equal, and each package loads the other's state."""
    from groundgrid_tpu.eval.metrics import Evaluator as JEval

    from groundgrid_torch.eval.metrics import Evaluator as TEval

    j, t = JEval("07"), TEval("07")
    for pred, gt in _random_clouds(3):
        j.add_cloud(pred, gt)
        t.add_cloud(pred, gt)
    assert t.compute().as_dict() == j.compute().as_dict()
    assert t.format_statistics() == j.format_statistics()
    assert t.per_label_table() == j.per_label_table()
    assert t.state_dict() == j.state_dict()
    t2, j2 = TEval(), JEval()
    t2.load_state_dict(j.state_dict())
    j2.load_state_dict(t.state_dict())
    assert t2.format_statistics() == j2.format_statistics() == j.format_statistics()


def test_baseline_comparison_text():
    from groundgrid_tpu.eval.baseline import REFERENCE_SEQ00, format_baseline_comparison as jf

    from groundgrid_torch.eval.baseline import format_baseline_comparison as tf_

    worse = dict(REFERENCE_SEQ00, ioug=REFERENCE_SEQ00["ioug"] - 0.006)
    for metrics, scans in ((dict(REFERENCE_SEQ00), 4540), (worse, 4540),
                           (dict(REFERENCE_SEQ00), 100)):
        assert tf_(metrics, scans) == jf(metrics, scans)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_semantickitti_round_trip_both_ways(tmp_path, writer):
    """What either package writes, both read bitwise alike."""
    from groundgrid_tpu.data import semantickitti as jk

    from groundgrid_torch.data import semantickitti as tk

    scans = list(tsyn.synthetic_sequence(3, seed=2, n_beams=8, n_azimuth=90))
    (tk if writer == "torch" else jk).write_sequence(str(tmp_path), 4, scans)
    a, b = tk.SemanticKITTI(str(tmp_path), 4), jk.SemanticKITTI(str(tmp_path), 4)
    assert len(a) == len(b) == 3
    np.testing.assert_array_equal(a.times, b.times)
    np.testing.assert_array_equal(a.poses, b.poses)
    assert a.seek_index(0.15) == b.seek_index(0.15) == 2
    for k, (pts, lbl, T) in enumerate(scans):
        ra, rb = a.read_scan(k), b.read_scan(k)
        for f in ("index", "timestamp"):
            assert getattr(ra, f) == getattr(rb, f)
        np.testing.assert_array_equal(ra.points, rb.points)
        np.testing.assert_array_equal(ra.points[:, :3], pts[:, :3])
        np.testing.assert_array_equal(ra.labels, rb.labels)
        np.testing.assert_allclose(ra.t_map_velo, T, atol=1e-9)


def test_kitti_calibration_bitwise():
    P = np.array([[0.9, -0.1, 0.0, 12.5], [0.1, 0.9, 0.0, -3.25], [0.0, 0.0, 1.0, 0.5]])
    np.testing.assert_array_equal(ttf.KITTI_TR, jtf.KITTI_TR)
    np.testing.assert_array_equal(ttf.kitti_pose_to_map(P), jtf.kitti_pose_to_map(P))


def test_viz_exports_bytes(tmp_path):
    """Layer PNGs, terrain artifacts, the segmented-cloud image and the packed
    3-D cloud: byte for byte."""
    from groundgrid_tpu.runtime import viz as jv

    from groundgrid_torch.runtime import viz as tv

    rng = np.random.default_rng(9)
    layers = {"ground": rng.normal(0, 1, (24, 24)).astype(np.float32),
              "points_raw": rng.integers(0, 9, (24, 24)).astype(np.float32),
              "flat": np.zeros((24, 24), np.float32)}
    for name, mod in (("t", tv), ("j", jv)):
        mod.export_layers(layers, str(tmp_path / name), prefix="000008_")
        mod.save_terrain_artifact(str(tmp_path / name), layers["ground"], layers["points_raw"],
                                  8, 1.5, -2.25)
    for f in sorted((tmp_path / "j").iterdir()):
        assert (tmp_path / "t" / f.name).read_bytes() == f.read_bytes(), f.name
    assert len(list((tmp_path / "t").iterdir())) == 4
    x, y = rng.uniform(-30, 30, 500), rng.uniform(-30, 30, 500)
    z = rng.uniform(-1, 2, 500).astype(np.float32)
    lab = rng.choice([0, 49, 99], 500).astype(np.int32)
    np.testing.assert_array_equal(tv.render_segmented_cloud(x, y, lab, (0.5, -1.0), size=128),
                                  jv.render_segmented_cloud(x, y, lab, (0.5, -1.0), size=128))
    kw = dict(ground=layers["ground"], resolution=0.5, max_points=300, terrain_side=12)
    assert (tv.pack_cloud_3d(x, y, z, lab, (0.5, -1.0), 0.25, **kw)
            == jv.pack_cloud_3d(x, y, z, lab, (0.5, -1.0), 0.25, **kw))


def test_lazy_exports():
    """The data, scoring and viewer entry points resolve from the package."""
    import groundgrid_torch
    from groundgrid_torch.data import native_loader, semantickitti
    from groundgrid_torch.eval import device, metrics
    from groundgrid_torch.runtime import live

    assert groundgrid_torch.SemanticKITTI is semantickitti.SemanticKITTI
    assert groundgrid_torch.ScanRecord is semantickitti.ScanRecord
    assert groundgrid_torch.Evaluator is metrics.Evaluator
    assert groundgrid_torch.DeviceEvaluator is device.DeviceEvaluator
    assert groundgrid_torch.SortedPrefetchingLoader is native_loader.SortedPrefetchingLoader
    assert groundgrid_torch.WirePrefetchingLoader is native_loader.WirePrefetchingLoader
    assert groundgrid_torch.LiveServer is live.LiveServer
    with pytest.raises(AttributeError):
        groundgrid_torch.NoSuchName
