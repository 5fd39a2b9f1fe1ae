"""The port's copies of framework-free pieces equal the JAX package's originals.

``groundgrid_torch`` cannot import ``groundgrid_tpu`` (that imports JAX), so
it carries copies of the config dataclass, the host transforms, the detect
tables' expected-points table and the synthetic scan generator. These tests
hold each copy to its original: same fields and defaults, bitwise outputs.
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
