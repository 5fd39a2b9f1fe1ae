"""The port's CLI (``python -m groundgrid_torch``) on fabricated datasets.

Mirrors ``tests/test_cli.py`` at its small geometry on the CPU
(``--device cpu``: the kernels' plain versions), and holds the port's
``evaluate`` to the JAX package's on the same dataset: equal scored-point
totals, recall / precision / F1 / IoUg within 0.1 pt (the JAX ``accuracy``
budget). On-device scoring, the native loaders and the pipelined driver are
bitwise the lock-step run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from groundgrid_torch.data.semantickitti import write_sequence
from groundgrid_torch.data.synthetic import synthetic_sequence
from groundgrid_torch.runtime.cli import _parse_sequences, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = ["--dimension", "24", "--resolution", "0.5", "--max-points", "4096"]
COMMON = GEOMETRY + ["--device", "cpu"]
COUNTS = ("scans", "true_positive", "false_positive", "true_negative", "false_negative",
          "gt_ground_total")


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_torch_cli")
    for seq in (0, 1):
        write_sequence(root, seq, list(synthetic_sequence(2, seed=seq, n_beams=10,
                                                          n_azimuth=180)))
    return str(root)


@pytest.fixture(scope="module")
def long_dataset_root(tmp_path_factory):
    """Six-scan single sequence for window/resume tests (dt = 0.1 s)."""
    root = tmp_path_factory.mktemp("kitti_torch_cli_long")
    write_sequence(root, 0, list(synthetic_sequence(6, seed=5, n_beams=10, n_azimuth=180)))
    return str(root)


def _eval_payload(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _evaluate(capsys, root, *extra, sequence="00"):
    rc = main(["evaluate", "--directory", root, "--sequence", sequence] + COMMON + list(extra))
    assert rc == 0
    return _eval_payload(capsys)


def test_parse_sequences():
    assert _parse_sequences("00") == ["00"]
    assert _parse_sequences("3") == ["03"]
    assert _parse_sequences("00-03") == ["00", "01", "02", "03"]
    assert _parse_sequences("0,5, 10") == ["00", "05", "10"]


def test_evaluate_single_sequence(dataset_root, capsys):
    rc = main(["evaluate", "--directory", dataset_root, "--sequence", "00"] + COMMON)
    assert rc == 0
    out = capsys.readouterr().out
    payload = json.loads(out.strip().splitlines()[-1])
    assert payload["scans"] == 2 and payload["pipeline_depth"] == 0
    assert payload["recall"] > 0.8
    assert "IoUg" in out  # reference-format statistics block
    assert "seq-00 comparison vs reference" in out


def test_evaluate_multi_sequence(dataset_root, capsys):
    payload = _evaluate(capsys, dataset_root, sequence="00-01")
    assert payload["scans"] == 4
    assert set(payload["per_sequence"]) == {"00", "01"}


def test_evaluate_wire_flag(dataset_root, capsys):
    """--wire (s16 quantized ingest) stays within quantization noise of f32."""
    base = _evaluate(capsys, dataset_root)
    wire = _evaluate(capsys, dataset_root, "--wire")
    assert wire["scans"] == base["scans"]
    for k in ("precision", "recall", "f1", "ioug"):
        assert abs(wire[k] - base[k]) < 0.01, (k, wire[k], base[k])


def test_playback_wire_flag(dataset_root, capsys):
    rc = main(["playback", "--directory", dataset_root, "--sequence", "00", "--wire"] + COMMON)
    assert rc == 0
    assert "scan 0:" in capsys.readouterr().out


@pytest.fixture(scope="module")
def eleven_seq_root(tmp_path_factory):
    """An 11-'sequence' dataset: the BASELINE config-3 aggregate in miniature."""
    root = tmp_path_factory.mktemp("kitti_torch_00_10")
    for seq in range(11):
        write_sequence(root, seq, list(synthetic_sequence(2, seed=100 + seq, n_beams=10,
                                                          n_azimuth=180)))
    return str(root)


def test_evaluate_00_10_aggregate_host_vs_device(eleven_seq_root, capsys):
    """'evaluate --sequence 00-10': the host scorer and the device table
    (int32 with int64 host drains) agree on the aggregate exactly."""
    host = _evaluate(capsys, eleven_seq_root, sequence="00-10")
    assert host["scans"] == 22
    assert set(host["per_sequence"]) == {f"{s:02d}" for s in range(11)}
    dev = _evaluate(capsys, eleven_seq_root, "--on-device-eval", sequence="00-10")
    for k in COUNTS:
        assert dev[k] == host[k], (k, dev[k], host[k])
    assert dev["per_sequence"] == host["per_sequence"]


def test_playback_with_exports(dataset_root, capsys, tmp_path):
    rc = main(["playback", "--directory", dataset_root, "--sequence", "00",
               "--export-layers", str(tmp_path / "layers"),
               "--export-terrain", str(tmp_path / "terrain"),
               "--export-every", "1"] + COMMON)
    assert rc == 0
    assert "scans/s" in capsys.readouterr().out
    # eleven published layers per exported scan
    assert len(list((tmp_path / "layers").glob("000000_*.png"))) == 11
    assert len(list((tmp_path / "layers").glob("*.png"))) == 22
    terrain = sorted((tmp_path / "terrain").glob("*.npy"))
    assert len(terrain) == 2
    arr = np.load(terrain[0])
    assert arr.shape == (48, 48, 3) and np.isfinite(arr).all()


@pytest.mark.parametrize("variant", [
    ["--pipeline-depth", "2"],
    ["--native-loader"],
    ["--native-loader", "--pipeline-depth", "2"],
    ["--on-device-eval"],
    ["--native-loader", "--on-device-eval"],
], ids=["pipelined", "native", "native-pipelined", "on-device", "native-on-device"])
def test_evaluate_variants_match_lockstep(long_dataset_root, capsys, variant):
    """Pipelining, native prep and on-device scoring change no count, and
    no metric (bitwise-equal labels against the same ground truth)."""
    want = _evaluate(capsys, long_dataset_root)
    got = _evaluate(capsys, long_dataset_root, *variant)
    for key in COUNTS + ("precision", "recall", "f1", "accuracy", "ioug"):
        assert got[key] == want[key], key


def test_evaluate_wire_native_matches_wire(long_dataset_root, capsys):
    want = _evaluate(capsys, long_dataset_root, "--wire")
    got = _evaluate(capsys, long_dataset_root, "--wire", "--native-loader")
    for key in COUNTS:
        assert got[key] == want[key], key


def test_pipeline_depth_checkpoint_exclusive(long_dataset_root, capsys, tmp_path):
    for cmd in ("evaluate", "playback"):
        rc = main([cmd, "--directory", long_dataset_root, "--sequence", "00",
                   "--pipeline-depth", "2", "--checkpoint", str(tmp_path / "x.npz")] + COMMON)
        assert rc == 2
        assert "mutually exclusive" in capsys.readouterr().err
    rc = main(["evaluate", "--directory", long_dataset_root, "--on-device-eval",
               "--checkpoint", str(tmp_path / "x.npz")] + COMMON)
    assert rc == 2
    assert not (tmp_path / "x.npz").exists()


def test_playback_export_html(dataset_root, capsys, tmp_path):
    out_html = tmp_path / "seq.html"
    rc = main(["playback", "--directory", dataset_root, "--sequence", "00",
               "--export-html", str(out_html), "--html-every", "1"] + COMMON)
    assert rc == 0
    assert "2-frame player" in capsys.readouterr().out
    html = out_html.read_text()
    assert html.count("data:image/png;base64,") == 2
    assert "groundgrid-torch seq 00" in html


def test_live_server_follow_protocol():
    """LiveServer append/follow protocol: late join, incremental fetch, done."""
    import urllib.request

    from groundgrid_torch.runtime.live import LiveServer

    live = LiveServer(port=0, keep=3, size=64).start()  # port 0: ephemeral
    try:
        def get(path):
            with urllib.request.urlopen(live.url.rstrip("/") + path, timeout=5) as r:
                return json.loads(r.read())

        assert get("/status") == {"total": 0, "done": False}
        rng = np.random.default_rng(0)
        for k in range(5):
            live.add(rng.uniform(-10, 10, 50), rng.uniform(-10, 10, 50),
                     np.full(50, 49, np.int32), np.zeros(2), caption=f"s{k}")
        d = get("/frames?since=0")  # late joiner: the ring kept the last 3
        assert d["next"] == 5 and d["start"] == 2
        assert len(d["frames"]) == 3 and d["captions"] == ["s2", "s3", "s4"]
        assert d["frames"][0].startswith("data:image/png;base64,")
        d = get("/frames?since=5")
        assert d["frames"] == [] and d["next"] == 5
        live.finish()
        assert get("/status")["done"] is True
        with urllib.request.urlopen(live.url, timeout=5) as r:
            assert b"groundgrid-torch live" in r.read()
    finally:
        live.stop()


def test_sequence_recorder_embed_3d(tmp_path):
    """Offline player: sparse packed-cloud embedding + 3-D toggle assets."""
    from groundgrid_torch.runtime.viz import SequenceRecorder

    rng = np.random.default_rng(2)
    rec = SequenceRecorder(size=64, embed_3d_every=2, max_3d=3)
    n = 200
    for _ in range(8):
        rec.add(rng.uniform(-10, 10, n), rng.uniform(-10, 10, n), np.full(n, 49, np.int32),
                np.zeros(2), z=rng.uniform(-1, 1, n).astype(np.float32), z0=0.0,
                layer=rng.uniform(-1, 1, (8, 8)).astype(np.float32), resolution=0.5)
    assert sorted(rec.clouds) == [0, 2, 4]  # every 2nd recorded frame, capped at 3
    rec.write_html(str(tmp_path / "p.html"))
    html = (tmp_path / "p.html").read_text()
    assert "gg3dView" in html and '"terrain"' in html


def test_playback_serve_live(dataset_root, capsys, monkeypatch):
    """--serve drives the live viewer during a real playback run."""
    from groundgrid_torch.runtime import live as livemod

    seen = {}
    orig_start = livemod.LiveServer.start

    def spy_start(self):
        seen["server"] = self
        return orig_start(self)

    monkeypatch.setattr(livemod.LiveServer, "start", spy_start)
    rc = main(["playback", "--directory", dataset_root, "--sequence", "00",
               "--serve", "0", "--serve-linger", "0", "--html-every", "1"] + COMMON)
    assert rc == 0
    assert seen["server"]._total == 2 and seen["server"]._done


def test_sequence_recorder_capacity():
    from groundgrid_torch.runtime.viz import SequenceRecorder

    rec = SequenceRecorder(size=64, max_frames=2)
    x, labels = np.zeros(10), np.full(10, 49)
    assert rec.add(x, x, labels, (0.0, 0.0), caption="a")
    assert rec.add(x, x, labels, (0.0, 0.0))
    assert not rec.add(x, x, labels, (0.0, 0.0))
    assert rec.dropped == 1 and len(rec.frames) == 2


@pytest.mark.parametrize("native", [False, True])
def test_evaluate_start_end_window(long_dataset_root, capsys, native):
    """--start/--end select the same scan window on every loader path, and
    the native loader bins the window against the track a driver starting
    there keeps: its counts are the raw path's."""
    window = ["--start", "0.15", "--end", "0.45"]
    want = _evaluate(capsys, long_dataset_root, *window)
    extra = ["--native-loader"] if native else []
    payload = _evaluate(capsys, long_dataset_root, *window, *extra)
    assert payload["scans"] == 3  # t = 0.2, 0.3, 0.4
    for key in COUNTS:
        assert payload[key] == want[key], key


def test_evaluate_resume_bitwise(long_dataset_root, capsys, tmp_path):
    """checkpoint after scan 3 + resume == uninterrupted run, count-exact."""
    want = _evaluate(capsys, long_dataset_root)
    ckpt = str(tmp_path / "state.npz")
    _evaluate(capsys, long_dataset_root, "--end", "0.25",  # stop after scan 2 (t = 0.2)
              "--checkpoint", ckpt, "--checkpoint-every", "3")
    got = _evaluate(capsys, long_dataset_root, "--checkpoint", ckpt, "--resume")
    for key in COUNTS:
        assert got[key] == want[key], key


@pytest.mark.parametrize("loaders", [("--native-loader", ""), ("", "--native-loader"),
                                     ("--native-loader", "--native-loader")],
                         ids=["native-then-raw", "raw-then-native", "native"])
def test_evaluate_resume_across_loaders(long_dataset_root, capsys, tmp_path, loaders):
    """A checkpoint written on one loader path resumes on the other bitwise:
    both carry the stream's exact f64 center."""
    want = _evaluate(capsys, long_dataset_root)
    first, second = ([flag] if flag else [] for flag in loaders)
    ckpts = {}
    for name, flags in (("raw", []), ("used", first)):
        ckpts[name] = str(tmp_path / f"{name}.npz")
        _evaluate(capsys, long_dataset_root, "--end", "0.25", "--checkpoint", ckpts[name],
                  "--checkpoint-every", "3", *flags)
    np.testing.assert_array_equal(np.load(ckpts["used"])["center64"],
                                  np.load(ckpts["raw"])["center64"])
    got = _evaluate(capsys, long_dataset_root, "--checkpoint", ckpts["used"], "--resume",
                    *second)
    for key in COUNTS:
        assert got[key] == want[key], key


def test_playback_resume(long_dataset_root, capsys, tmp_path):
    ckpt = str(tmp_path / "play.npz")
    rc = main(["playback", "--directory", long_dataset_root, "--sequence", "00",
               "--end", "0.35", "--checkpoint", ckpt, "--checkpoint-every", "2"] + COMMON)
    assert rc == 0
    first = capsys.readouterr().out.count("scan ")
    rc = main(["playback", "--directory", long_dataset_root, "--sequence", "00",
               "--checkpoint", ckpt, "--resume"] + COMMON)
    assert rc == 0
    out = capsys.readouterr().out
    assert first == 4 and out.count("scan ") == 2  # resumes at scan 4


def test_unported_options_raise(long_dataset_root, monkeypatch):
    """bench --batch > 1 is not ported; --device cuda without a card raises
    instead of running on the CPU."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["bench", "--batch", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("evaluate", "playback"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([cmd, "--directory", long_dataset_root] + GEOMETRY)
    with pytest.raises(RuntimeError):
        main(["bench", "--scans", "1"])


@pytest.mark.parametrize("extra", [[], ["--native-loader"], ["--on-device-eval"],
                                   ["--native-loader", "--pipeline-depth", "2"]])
def test_evaluate_no_sorted_matches_lockstep(long_dataset_root, capsys, extra):
    """Unsorted mode (raw scans, transform and sort on the device): the raw
    native loader, on-device scoring and pipelining are bitwise the
    lock-step run, whose scores stay within 0.1 pt of sorted mode's."""
    base = _evaluate(capsys, long_dataset_root, "--no-sorted")
    got = _evaluate(capsys, long_dataset_root, "--no-sorted", *extra)
    assert base["scans"] == got["scans"] == 6
    for key in COUNTS + ("f1", "ioug"):
        assert got[key] == base[key], key
    srt = _evaluate(capsys, long_dataset_root)
    for key in ("f1", "ioug"):
        assert abs(base[key] - srt[key]) * 100.0 < 0.1, key


def _run_module(package, args, env=None):
    proc = subprocess.run([sys.executable, "-m", package] + args, capture_output=True,
                          text=True, cwd=REPO, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_evaluate(long_dataset_root, tmp_path_factory):
    """``python -m groundgrid_tpu evaluate`` (sorted mode, on the CPU) on the
    six-scan sequence: the whole run, and the first three scans with a
    checkpoint after them."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "jax_state.npz")
    base = ["evaluate", "--directory", long_dataset_root, "--sequence", "00", "--sorted"]
    whole = _run_module("groundgrid_tpu", base + GEOMETRY, env)
    _run_module("groundgrid_tpu", base + GEOMETRY + ["--end", "0.25", "--checkpoint", ckpt,
                                                     "--checkpoint-every", "3"], env)
    return whole, ckpt


def _within_budget(got, want):
    for key in ("recall", "precision", "f1", "ioug"):
        assert abs(got[key] - want[key]) * 100.0 < 0.1, (key, got[key], want[key])


def test_port_evaluate_matches_jax_package(long_dataset_root, jax_evaluate):
    """``python -m groundgrid_torch evaluate --device cpu`` against
    ``python -m groundgrid_tpu evaluate`` on the same sequence."""
    want, _ = jax_evaluate
    got = _run_module("groundgrid_torch",
                      ["evaluate", "--directory", long_dataset_root, "--sequence", "00"]
                      + COMMON)
    assert got["scans"] == want["scans"] == 6
    scored = ("true_positive", "false_positive", "true_negative", "false_negative")
    assert sum(got[k] for k in scored) == sum(want[k] for k in scored)
    assert got["gt_ground_total"] == want["gt_ground_total"]
    _within_budget(got, want)


def test_port_resumes_jax_checkpoint(long_dataset_root, jax_evaluate, capsys):
    """A checkpoint the JAX CLI wrote after scan 3 (grid state, tracker
    center and both evaluators) is resumed by the port's CLI."""
    want, ckpt = jax_evaluate
    got = _evaluate(capsys, long_dataset_root, "--checkpoint", ckpt, "--resume")
    assert got["scans"] == want["scans"] == 6
    _within_budget(got, want)
