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


def _prepared_scan(jcfg, tcfg, small_scans, k=2):
    """Scan ``k`` prepared for both steps against the stream's last center."""
    pts, labels, T = small_scans[k]
    tracker = jpipe.CenterTracker(jcfg, small_scans[0][2][:2, 3].astype(np.float64))
    for _, _, Tk in small_scans:
        center = tracker.update(Tk[:2, 3].astype(np.float64))
    jscan, _ = jpipe.prepare_scan(jcfg, pts, labels, T, center)
    tscan, _ = tpipe.prepare_scan(tcfg, pts, labels, T, center, "cpu")
    return jscan, tscan


def test_unsorted_scan_falls_back_and_matches_jax(runs, small_scans):
    """A shuffled prepared scan: the JAX step takes its scatter fallback, the
    port counts a fallback and sorts on the device; both agree."""
    jcfg, tcfg, _, jstates = runs[:4]
    jscan, tscan = _prepared_scan(jcfg, tcfg, small_scans)
    sorted_scan = tscan
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
        state_from_numpy(*jstates[1], device="cpu"), sorted_scan)
    np.testing.assert_array_equal(tstate.ground.numpy(), sorted_state.ground.numpy())


def test_no_fallback_check_on_sorted_stream_is_the_default(runs, small_scans):
    """``sorted_fallback_check=False`` on the sorted stream: labels and state
    bitwise those of the checked default, and no fallback."""
    tcfg, tres, tstates = runs[1], runs[4], runs[5]
    driver, again = _run_port(dataclasses.replace(tcfg, sorted_fallback_check=False),
                              small_scans)
    for a, b in zip(tres, again):
        np.testing.assert_array_equal(a.labels, b.labels)
    for a, b in zip(tstates[-1], state_to_numpy(driver.state)):
        np.testing.assert_array_equal(a, b)
    assert driver.step.fallbacks == 0


def test_no_fallback_check_makes_no_sortedness_read(runs, small_scans, monkeypatch):
    """Unchecked, a shuffled scan takes no fallback; checked, it takes one,
    and the check reads nothing back (the choice is made on the device):
    both steps make the same host reads."""
    jcfg, tcfg, _, jstates = runs[:4]
    _, tscan = _prepared_scan(jcfg, tcfg, small_scans)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(tcfg.max_points))
    tscan = tscan._replace(**{k: getattr(tscan, k)[perm]
                              for k in ("px", "py", "pz", "rings", "valid")})
    reads = []
    to_bool = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append(1) or to_bool(t))
    counts = {}
    for check in (True, False):
        step = tpipe.make_step(dataclasses.replace(tcfg, sorted_fallback_check=check))
        reads.clear()
        step(state_from_numpy(*jstates[1], device="cpu"), tscan)
        counts[check] = (len(reads), step.fallbacks)
    assert counts[True][1] == 1 and counts[False][1] == 0
    assert counts[False][0] == counts[True][0]


def test_no_fallback_check_matches_jax(runs, small_scans):
    """The port and the JAX step, both with ``sorted_fallback_check=False``,
    on a sorted scan from the same state."""
    jcfg, tcfg, _, jstates = runs[:4]
    jcfg = dataclasses.replace(jcfg, sorted_fallback_check=False)
    tcfg = dataclasses.replace(tcfg, sorted_fallback_check=False)
    jscan, tscan = _prepared_scan(jcfg, tcfg, small_scans)
    jstate, jout = jpipe.make_step(jcfg)(jpipe.GridState(*jstates[1]), jscan)
    step = tpipe.make_step(tcfg)
    tstate, tout = step(state_from_numpy(*jstates[1], device="cpu"), tscan)
    assert step.fallbacks == 0
    lj, lt = np.asarray(jout.labels), tout.labels.numpy()
    assert (lj != 0).sum() > 1000
    assert (lj == lt).mean() >= AGREE, f"{int((lj != lt).sum())} labels differ"
    close = np.abs(tstate.ground.numpy() - np.asarray(jstate.ground)) <= 1e-4
    assert close.mean() >= AGREE


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


@pytest.mark.parametrize("config", [
    TConfig(),  # the default: unsorted mode at 364^2
    TConfig(dimension=40.0, resolution=0.5, max_points=(1 << 17) + 640, ray_steps=40,
            sorted_scans=True),  # past the march key's index bits
])
def test_default_and_large_configurations_step(config, small_scans):
    """Once refused: ``make_step(GroundGridConfig())`` and a buffer above
    131,072 points build and step through the driver."""
    tpipe.make_step(config)
    driver = StreamingDriver(config, device="cpu")
    for i, (pts, labels, T) in enumerate(small_scans[:2]):
        res = driver.process(ScanRecord(index=i, timestamp=0.1 * i, points=pts, labels=labels,
                                        t_map_velo=T))
        assert res.labels.shape == (pts.shape[0],)
        assert np.isin(res.labels, (0, 49, 99)).all()
        assert (res.labels == 49).sum() > 1000 and (res.labels == 99).sum() > 100
    assert driver.step.fallbacks == 0
