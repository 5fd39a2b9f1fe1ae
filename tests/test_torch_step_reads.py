"""The step reads nothing back to the host, and computes what it did when it did.

The march always runs the fixed ``k_max`` candidate buffer, where it once
read the marchable count and marched only those candidates; the sortedness
check counts on the device and the raster's inputs take the stable sort of
the ids (of sorted ids the identity), where the check once read a Python
``bool`` and sorted only unsorted scans. Both old forms are rebuilt here as references from the port's
own functions (a counted march is the fixed march with its cap set to the
count), and the new forms must equal them bitwise: outliers, labels and the
grid state over a moving sequence, at the cap with shedding below and above
2^17 points, and on a shuffled scan in sorted mode. ``Step.marchable`` and
``Step.fallbacks`` read the same counts as before.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from groundgrid_torch import GroundGridConfig, ScanRecord, StreamingDriver
from groundgrid_torch import pipeline as tpipe
from groundgrid_torch.core import outliers as toutliers
from groundgrid_torch.core import rasterize as traster
from groundgrid_torch.core import scalars as tscalars
from groundgrid_torch.core import transforms as ttf
from groundgrid_torch.core.grid import state_from_numpy, state_to_numpy
from groundgrid_torch.data.synthetic import adversarial_sequence
from groundgrid_torch.ops import march, select

from test_torch_outliers_topk import N_LONG, N_SHORT, N_TIED, _scene

torch.set_num_threads(1)

# tests/conftest.py's small_config, sorted scans
SMALL = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=16384, ray_steps=40,
                         max_outlier_candidates=1024, sorted_scans=True)


@contextlib.contextmanager
def host_reads():
    """Records every read of a tensor's value into a Python object."""
    reads = []
    names = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist")
    saved = {name: getattr(torch.Tensor, name) for name in names}

    def recorder(name):
        def read(t, *args):
            reads.append(name)
            return saved[name](t, *args)
        return read

    for name in names:
        setattr(torch.Tensor, name, recorder(name))
    try:
        yield reads
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


fixed_detect_outliers = toutliers.detect_outliers


def counted_detect_outliers(config, *args):
    """The march before the fixed buffer: read the marchable count, then
    march only min(count, cap) candidates."""
    _, marchable = fixed_detect_outliers(config, *args)
    n_act = min(int(marchable), config.max_outlier_candidates)
    out, _ = fixed_detect_outliers(
        dataclasses.replace(config, max_outlier_candidates=n_act), *args)
    return out, int(marchable)


def host_read_config(config, cell):
    """The sortedness check before the device count: a Python ``bool`` on the
    host, which left sorted ids unsorted-through (no check, no sort) and
    sorted the rest on the device."""
    if bool((cell[1:] >= cell[:-1]).all()):
        return dataclasses.replace(config, sorted_fallback_check=False)
    return config


def _records(n_scans=6):
    """A moving stream of the adversarial world, where outliers fire."""
    return [ScanRecord(index=k, timestamp=0.1 * k, points=p, labels=l, t_map_velo=T)
            for k, (p, l, T) in enumerate(
                adversarial_sequence(n_scans, seed=3, n_beams=24, n_azimuth=600, step_m=1.5))]


def _run(records, monkeypatch=None, counted=False):
    driver = StreamingDriver(SMALL, device="cpu")
    if counted:
        monkeypatch.setattr(tpipe.outlierlib, "detect_outliers", counted_detect_outliers)
    results, marchable, states = [], [], []
    for rec in records:
        results.append(driver.process(rec))
        marchable.append(driver.step.marchable)
        states.append(state_to_numpy(driver.state))
    return results, marchable, states


def test_fixed_march_matches_counted_march_over_sequence(monkeypatch):
    """Outliers, labels, layers and ``Step.marchable`` over a moving stream,
    whose first scan sheds (a flat initial terrain under nearly every
    point) and the rest pad the buffer."""
    records = _records()
    got, got_marchable, got_states = _run(records)
    want, want_marchable, want_states = _run(records, monkeypatch, counted=True)
    assert got_marchable == want_marchable
    assert want_marchable[0] > SMALL.max_outlier_candidates > max(want_marchable[1:]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.outlier, b.outlier)
        np.testing.assert_array_equal(a.labels, b.labels)
    for a, b in zip(got_states, want_states):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert sum(int(r.outlier.sum()) for r in got) > 0


@pytest.mark.parametrize("cap", [450, 2000])
@pytest.mark.parametrize("p_total", [1 << 17, (1 << 17) + 640, 1 << 18])
def test_fixed_march_at_the_cap(p_total, cap):
    """``test_torch_outliers_topk.py``'s scene (800 marchable candidates, the
    cut inside a group of equal budgets) on both selection keys: shedding to
    450, and a 2000 buffer padded with 1200 zero budgets."""
    cfg = GroundGridConfig(dimension=40.0, resolution=0.5, max_points=p_total, ray_steps=40,
                           max_outlier_candidates=cap)
    n = cfg.cell_count
    (x, y, z), valid, _ = _scene(p_total)
    t = [torch.from_numpy(a) for a in (x, y, z)]
    center = lo = np.zeros(2, np.float32)
    s = tscalars.host(cfg, center, lo, ttf.translation(0.0, 0.0, 1.7, np.float32))
    ground = torch.zeros((n, n))
    conf = torch.ones((n, n))
    binning = traster.bin_points(cfg, s, t[0], t[1], torch.zeros(p_total, dtype=torch.int32),
                                 torch.from_numpy(valid))
    args = (s, ground, conf, binning, *t, march.march_budget, select.select_candidates,
            march.march)
    with host_reads() as reads:
        got, marchable = fixed_detect_outliers(cfg, *args)
    assert reads == []
    want, want_marchable = counted_detect_outliers(cfg, *args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(marchable) == want_marchable == N_LONG + N_TIED + N_SHORT
    fired = int(got.sum())
    assert fired == cap if cap < want_marchable else fired >= N_LONG + N_TIED


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("shuffled", [False, True])
def test_device_choice_matches_host_read_version(shuffled, with_aux):
    """A prepared scan, shuffled or not, through the sorted-mode step: the
    device count and the stable sort of every scan give bitwise the state,
    outputs and layers of the host-read check, and ``Step.fallbacks`` the
    same count."""
    records = _records(3)
    driver = StreamingDriver(SMALL, device="cpu")
    for rec in records[:2]:
        driver.process(rec)
    scan, _ = driver.make_scan(records[2])
    if shuffled:
        perm = torch.from_numpy(np.random.default_rng(0).permutation(SMALL.max_points))
        scan = scan._replace(**{k: getattr(scan, k)[perm]
                                for k in ("px", "py", "pz", "rings", "valid")})
    start = state_to_numpy(driver.state)
    s = tscalars.host(SMALL, scan.center, scan.center_lo, scan.t_map_velo)
    cell = traster.bin_points(SMALL, s, scan.px, scan.py, scan.rings, scan.valid > 0).cell
    assert (host_read_config(SMALL, cell) is SMALL) is shuffled
    runs = []
    for config in (SMALL, host_read_config(SMALL, cell)):
        step = tpipe.make_step(config, with_aux=with_aux)
        state, *outs = step(state_from_numpy(*start, device="cpu"), scan)
        runs.append((state_to_numpy(state), [t for o in outs for t in o], step.fallbacks))
    (s1, o1, f1), (s2, o2, f2) = runs
    assert f1 == int(shuffled) and f2 == int(shuffled)
    for a, b in zip(s1, s2):
        np.testing.assert_array_equal(a, b)
    assert len(o1) == len(o2) == (16 if with_aux else 5)
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    assert (o1[0] == 49).sum() > 1000
