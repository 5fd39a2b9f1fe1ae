"""The port's streaming step end to end against the JAX package's.

Both drivers run the sorted-scan configuration over the same synthetic
stream (the JAX step on CPU, with its XLA paths; the port's with its plain
kernel versions on CPU tensors). Grid centers are bitwise; labels agree on
>= 99.9 % of points and ground on >= 99.9 % of cells within 1e-4, the bar of
``tests/test_pallas_raster.py``; two runs of the port are bitwise identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from groundgrid_tpu import pipeline as jpipe
from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.data.semantickitti import ScanRecord as JRecord
from groundgrid_tpu.runtime.driver import StreamingDriver as JDriver

from groundgrid_torch import GroundGridConfig as TConfig
from groundgrid_torch import ScanRecord, StreamingDriver, state_from_numpy, state_to_numpy
from groundgrid_torch import pipeline as tpipe

# the test workers share the CPU: torch's intra-op thread pools would
# oversubscribe it and stall on the many small ops of the plain versions
torch.set_num_threads(1)

AGREE = 0.999


def _configs(small_config):
    kw = {f: getattr(small_config, f) for f in small_config.__dataclass_fields__}
    kw["sorted_scans"] = True
    return JConfig(**kw), TConfig(**kw)


def _records(scans, cls):
    return [cls(index=i, timestamp=0.1 * i, points=p, labels=l, t_map_velo=T)
            for i, (p, l, T) in enumerate(scans)]


def _run_port(tcfg, scans):
    driver = StreamingDriver(tcfg, device="cpu")
    results = [driver.process(r) for r in _records(scans, ScanRecord)]
    return driver, results


@pytest.fixture(scope="module")
def runs(small_config, small_scans):
    jcfg, tcfg = _configs(small_config)
    jdriver = JDriver(jcfg)
    jres, jstates = [], []
    for rec in _records(small_scans, JRecord):
        jres.append(jdriver.process(rec))
        jstates.append([np.asarray(a) for a in jdriver.state])
    tdriver = StreamingDriver(tcfg, device="cpu")
    tres, tstates = [], []
    for rec in _records(small_scans, ScanRecord):
        tres.append(tdriver.process(rec))
        tstates.append(state_to_numpy(tdriver.state))
    return jcfg, tcfg, jres, jstates, tres, tstates, tdriver


def test_driver_matches_jax(runs):
    _, _, jres, jstates, tres, tstates, tdriver = runs
    total = mism = 0
    for a, b, sa, sb in zip(jres, tres, jstates, tstates):
        assert b.labels.shape == a.labels.shape and b.labels.dtype == a.labels.dtype
        mism += int((a.labels != b.labels).sum())
        total += a.labels.size
        np.testing.assert_array_equal(sb[2], sa[2])  # center
        np.testing.assert_array_equal(sb[3], sa[3])  # center_lo
        close = np.abs(sb[0] - sa[0]) <= 1e-4
        assert close.mean() >= AGREE, f"ground: {int((~close).sum())} cells beyond 1e-4"
        np.testing.assert_array_equal(b.outlier, a.outlier)
    assert 1 - mism / total >= AGREE, f"{mism} of {total} labels differ"
    assert tdriver.step.fallbacks == 0


def test_port_runs_are_bitwise_identical(runs, small_scans):
    tcfg, tres, tstates = runs[1], runs[4], runs[5]
    driver, again = _run_port(tcfg, small_scans)
    for a, b in zip(tres, again):
        np.testing.assert_array_equal(a.labels, b.labels)
    for a, b in zip(tstates[-1], state_to_numpy(driver.state)):
        np.testing.assert_array_equal(a, b)


def test_unsorted_scan_falls_back_and_matches_jax(runs, small_scans):
    """A shuffled prepared scan: the JAX step takes its scatter fallback, the
    port counts a fallback and sorts on the device; both agree."""
    jcfg, tcfg, _, jstates = runs[:4]
    pts, labels, T = small_scans[2]
    tracker = jpipe.CenterTracker(jcfg, small_scans[0][2][:2, 3].astype(np.float64))
    for _, _, Tk in small_scans:
        center = tracker.update(Tk[:2, 3].astype(np.float64))
    jscan, _ = jpipe.prepare_scan(jcfg, pts, labels, T, center)
    tscan, _ = tpipe.prepare_scan(tcfg, pts, labels, T, center, "cpu")
    perm = np.random.default_rng(0).permutation(jcfg.max_points)
    jscan = jscan._replace(**{k: np.asarray(getattr(jscan, k))[perm]
                              for k in ("px", "py", "pz", "rings", "valid")})
    tscan = tscan._replace(**{k: getattr(tscan, k)[torch.from_numpy(perm)]
                              for k in ("px", "py", "pz", "rings", "valid")})
    # both steps start from the JAX state after scan 1
    jstate = jpipe.GridState(*jstates[1])
    jstate, jout = jpipe.make_step(jcfg)(jstate, jscan)
    step = tpipe.make_step(tcfg)
    tstate, tout = step(state_from_numpy(*jstates[1], device="cpu"), tscan)
    assert step.fallbacks == 1
    lj, lt = np.asarray(jout.labels), tout.labels.numpy()
    assert (lj != 0).sum() > 1000
    assert (lj == lt).mean() >= AGREE, f"{int((lj != lt).sum())} labels differ"
    close = np.abs(tstate.ground.numpy() - np.asarray(jstate.ground)) <= 1e-4
    assert close.mean() >= AGREE
    # same result as the sorted scan: the fallback only reorders the raster
    sorted_state, sorted_out = tpipe.make_step(tcfg)(
        state_from_numpy(*jstates[1], device="cpu"), tpipe.prepare_scan(
            tcfg, pts, labels, T, center, "cpu")[0])
    np.testing.assert_array_equal(tstate.ground.numpy(), sorted_state.ground.numpy())


def test_empty_overflow_and_bad_pose_scans(small_config, small_scans):
    jcfg, tcfg = _configs(small_config)
    pts, labels, T = small_scans[0]
    big = np.concatenate([pts] * 2)[: tcfg.max_points + 500]
    big_lbl = np.concatenate([labels] * 2)[: tcfg.max_points + 500]
    bad = T.copy()
    bad[0, 3] = np.nan
    cases = [(pts[:0], labels[:0], T), (big, big_lbl, T), (pts, labels, bad)]
    jdriver, tdriver = JDriver(jcfg), StreamingDriver(tcfg, device="cpu")
    for i, (p, l, pose) in enumerate(cases):
        a = jdriver.process(JRecord(index=i, timestamp=0.0, points=p, labels=l, t_map_velo=pose))
        b = tdriver.process(ScanRecord(index=i, timestamp=0.0, points=p, labels=l,
                                       t_map_velo=pose))
        if a is None:
            assert b is None
            continue
        assert b.labels.shape == (p.shape[0],) == a.labels.shape
        assert (b.labels[tcfg.max_points:] == 0).all()
        assert (a.labels != b.labels).sum() <= (1 - AGREE) * p.shape[0]


@pytest.mark.parametrize("change", [{"sorted_scans": False}])
def test_unported_configurations_raise(small_config, change):
    _, tcfg = _configs(small_config)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.make_step(dataclasses.replace(tcfg, **change))
