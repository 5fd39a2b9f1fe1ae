"""The port's benchmark: one cell, one run, one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``portbench/configs/<name>.json``: the port's ``GroundGridConfig`` and the
sensor) under a traffic mix (``portbench/traffic/<name>.json``: which loop of
``loops.py`` drives the port, over which drives), with the limits its check
holds the outputs to (``portbench/checks/<cell>.json``). A per-layer metric
is read by ``portbench/metrics/<name>.py``. The harness finds each of these
by the names in ``BENCHMARK.json``, so a cell or a metric is added by adding
files and an entry.

A run: import the port and start the cell's cards (the traffic's
``cards``, one unless it says more); build or load its kernels; render the
traffic's pool of scans on the first card from ``--seed`` (for a
sorted-scan configuration, also every scan the run steps, prepared on the
cards: ``prepare.py``); warm up on a drive of its own (the first step
captures the CUDA graph); then measure for
``--seconds``, every unit on the host clock, and keep the outputs of the
checked positions; then replay the checked drive with the plain reference
and compare, each card's block of vehicles on its own card, the cards at
once. With ``--trace 1`` the
same run also records host spans and profiles stretches after the window,
and reports the per-layer metrics in
place of the end-to-end ones. Set-up is printed by part on standard error,
the numbers compared with their limits last there; the result is the last
line of standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "groundgrid_tpu")
# the port's hand-written kernels, by their names in the device trace
PORT_KERNELS = ("binning_kernel", "detect_kernel", "detect_stage_kernel", "lookup_kernel",
                "march_budget_kernel", "march_kernel", "move_kernel", "raster_reduce_kernel",
                "raster_columns_kernel", "raster_finish_kernel", "select_kernel",
                "spiral_kernel", "spiral_global_kernel")
PROFILE_SECONDS = 2.0


def process_age() -> float:
    """Seconds since this process started (its start time in /proc), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the port's runs must never load."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and
    limits, read from the files the names point to."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        found = [w for w in self.bench["workloads"] if w["name"] == workload]
        if not found:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = workload
        conf = [c for c in self.bench["configs"] if c["name"] == self.workload["config"]][0]
        self.config_file = json.loads((self.root / conf["file"]).read_text())
        base = self.root / BENCH_DIR
        self.traffic = json.loads((base / "traffic" / f"{self.workload['traffic']}.json")
                                  .read_text())
        self.limits = json.loads((base / "checks" / f"{workload}.json").read_text())["limits"]
        self.metrics_dir = base / "metrics"
        # the cards the traffic's loop steps on: a fleet's mesh, one block a card
        self.cards = int(self.traffic.get("cards", 1))
        if self.cards != int(self.workload["chips"]):
            raise ValueError(f"workload {workload!r} asks for {self.workload['chips']} chips "
                             f"but its traffic steps on {self.cards} cards")

    def reports(self, metric: dict) -> bool:
        """Whether this cell reports ``metric`` (an entry of ``end_to_end`` or
        ``per_layer``)."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        moves = metric.get("moves")
        if moves is None:
            return True
        e2e = [m for m in self.bench["end_to_end"] if m["name"] == moves][0]
        return self.reports(e2e)

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self.reports(m)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"] if self.reports(m)]


def mesh_devices(device, cards: int) -> list:
    """The cards a cell steps on: ``device`` alone for one card, else
    ``cuda:0`` .. ``cuda:{cards-1}`` (``device`` repeated off the card, as
    the CPU tests run a mesh)."""
    import torch

    if cards == 1:
        return [device]
    if device.type == "cuda":
        return [torch.device("cuda", k) for k in range(cards)]
    return [device] * cards


class Context:
    """What a run hands to the loops, the check and the metric readers;
    ``device`` is the first of the cell's ``devices``, where the traffic is
    rendered and the check runs."""

    def __init__(self, cell: Cell, seed: int, device):
        from portbench.traffic import check_positions

        self.cell = cell
        self.seed = seed
        self.device = device
        self.devices = mesh_devices(device, cell.cards)
        self.traffic = cell.traffic
        self.params = cell.config_file["groundgrid"]
        self.sensor = cell.config_file["sensor"]
        self.positions = check_positions(cell.traffic, seed)
        self.cfg = None
        self.pool = None
        self.loop = None
        self.tracer = None
        self.profile = None
        self.window = None


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values, q: float) -> float:
    """The q-th percentile of all ``values``, linear between ranks."""
    s = sorted(values)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def end_to_end_value(name: str, loop, window, setup_s: float) -> float:
    """An end-to-end metric by its name: ``setup_s``, ``scans_per_s[.<cells>]``
    (every scan completed in the window over its length), or
    ``<unit>_ms_p<q>`` (the q-th percentile of every unit's latency in the
    window, the unit ``tick`` in the fleet, ``scan`` otherwise)."""
    if name == "setup_s":
        return setup_s
    if name.split(".", 1)[0] == "scans_per_s":
        return window.scans / window.elapsed
    unit, _, q = name.rpartition("_ms_p")
    if unit != loop.unit_name or not q.isdigit():
        raise ValueError(f"end-to-end metric {name!r} does not fit a {loop.unit_name} loop")
    return 1000.0 * percentile(window.latencies, float(q))


def _chunk_rates(window, parts: int = 5) -> list:
    """Scans a second in each ``parts``-th of the window, by the units'
    host latencies (how steady the window was)."""
    out, t, n, edge = [], 0.0, 0, window.elapsed / parts
    for lat in window.latencies:
        t += lat
        n += window.unit_scans
        if t >= edge * (len(out) + 1) and len(out) < parts - 1:
            out.append(round(n / edge, 1))
            n = 0
    out.append(round(n / max(window.elapsed - edge * (parts - 1), 1e-9), 1))
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float | None = None, log=None) -> dict:
    """One run of one cell; returns the result line's object. ``device``
    "cpu" runs the port's plain kernels (the tests' tiny cells); ``t0`` is
    the process's start on the ``perf_counter`` clock (else now); ``log``
    takes the lines printed before the result."""
    import torch
    from groundgrid_torch import GroundGridConfig

    from portbench import check, loops, roofline, scenes
    from portbench.trace import Tracer, kernel_base, sync

    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(root, workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cx = Context(cell, seed, dev)
    if cuda:
        torch.cuda.init()
        for d in cx.devices:
            torch.zeros(1, device=d)
        sync(cx.devices)
    t_import = time.perf_counter() - t0
    cx.cfg = GroundGridConfig(**cx.params)
    build_s = 0.0
    if cuda:
        from groundgrid_torch.ops import _build

        build_s = _build.library().build_seconds
    t_build = time.perf_counter() - t0
    cx.pool = scenes.render_pool(cx.sensor, cell.traffic["scene"], int(cell.traffic["pool_scans"]),
                                 float(cell.traffic["step_m"]), cx.cfg.max_points, seed, dev)
    if cuda:
        sync(cx.devices)
        for d in cx.devices:
            torch.cuda.reset_peak_memory_stats(d)
    t_render = time.perf_counter() - t0
    loop = loops.LOOPS[cell.traffic["loop"]](cx)
    cx.loop = loop
    loop.warmup()
    if cuda:
        sync(cx.devices)
    setup_s = time.perf_counter() - t0
    steps = loop.step_objects()
    capture = sum(s.capture_seconds or 0.0 for s in steps)
    pool_bytes = sum(s.pool_bytes or 0 for s in steps)
    peaks_setup = [torch.cuda.max_memory_allocated(d) if cuda else 0 for d in cx.devices]
    prep_s = getattr(loop, "prepare_seconds", None)
    prep_line = "" if prep_s is None else f"prepared scans {prep_s:.3f} s of the "
    log(f"portbench {workload} seed {seed}: card {card_line() if cuda else 'none (cpu)'}; "
        f"peak {roofline.PEAK_SOURCE}")
    log(f"setup: import and CUDA init {t_import:.3f} s, kernels {t_build - t_import:.3f} s "
        f"(build_seconds {build_s:.3f}), render {t_render - t_build:.3f} s "
        f"({len(cx.pool.counts)} scans, {sum(cx.pool.counts) / len(cx.pool.counts):.0f} points "
        f"each), {prep_line}warm-up {setup_s - t_render:.3f} s (capture_seconds {capture:.4f}, "
        f"pool_bytes {pool_bytes}), setup_s {setup_s:.3f}, peak device memory by card "
        f"{peaks_setup}")

    if trace:
        tracer = Tracer(min(PROFILE_SECONDS, seconds), PORT_KERNELS)
        loop.tracer = cx.tracer = tracer
        if hasattr(loop, "driver"):
            dispatch = loop.driver.dispatch

            def timed_dispatch(rec):
                with tracer.span("dispatch"):
                    return dispatch(rec)

            loop.driver.dispatch = timed_dispatch
    window = cx.window = loop.run(seconds)
    if cuda:
        sync(cx.devices)
    peaks = [torch.cuda.max_memory_allocated(d) if cuda else 0 for d in cx.devices]
    counted = loop.counted()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded after the window: {found}")
    drive = loop.checked_drive(window)
    kept = loop.kept[drive]

    metrics = {}
    if trace:
        if cuda:
            tracer.profile_stretch(loop)
            p = tracer.profile
            k3 = sum(count for name, (_, count) in p["by_name"].items()
                     if kernel_base(name) == "spiral_kernel")
            log(f"profiled stretch: {len(p['units'])} units, {p['scans']} scans, {k3} K3 "
                f"launches, {p['port_launches']} port launches counted, {p['port_kernels_seen']} "
                f"seen, attempt {tracer.attempts}")
        cx.profile = tracer.profile
        for m in cell.per_layer():
            value = load_reader(cell.metrics_dir / f"{m['name']}.py")(cx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": end_to_end_value(m["name"], loop, window, setup_s),
                                  "unit": m["unit"]}

    # the check: the program's state freed, the reference replays the drive
    schedule, pool = loop.schedule, cx.pool
    loop.release()
    gc.collect()  # the traced run's dispatch wrapper and the driver hold each other
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, compared = check.replay_blocks(cx.params, pool, schedule, drive,
                                            loop.check_blocks(kept))
    numbers.update(counted)
    correct = check.verdict(numbers, cell.limits)
    lat = sorted(window.latencies)
    chunks = _chunk_rates(window)
    log(f"window units' host ms: p50 {1e3 * percentile(lat, 50):.3f}, p90 "
        f"{1e3 * percentile(lat, 90):.3f}, p99 {1e3 * percentile(lat, 99):.3f}, max "
        f"{1e3 * lat[-1]:.3f}; scans/s by fifth of the window {chunks}")
    log(f"peak device memory by card after the window {peaks}")
    log(f"window {window.elapsed:.3f} s, {window.units} units, {window.scans} scans;"
        f" check: drive {drive}, positions {sorted(kept)}, {compared} scans compared against "
        f"the reference in {time.perf_counter() - t_check:.1f} s")
    result = {
        "correct": bool(correct),
        "attempted": window.scans,
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": len(cx.devices), "memory_peak_bytes": int(max(peaks))},
    }
    if trace and tracer.profile is not None:
        p = tracer.profile
        # each card's union of its own activities, averaged over the cards used
        result["device"]["busy_s"] = sum(p["card_busy_us"].values()) / len(cx.devices) / 1e6
        result["device"]["window_s"] = p["window_us"] / 1e6
        result["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    result["checks"] = {k: {"value": numbers.get(k, float("nan")), "limit": cell.limits[k]}
                        for k in check.compared(cell.limits)}
    for k in check.compared(cell.limits):
        log(f"check {k} {result['checks'][k]['value']!r} limit {cell.limits[k]!r}")
    return result


def main(argv=None) -> int:
    t0 = time.perf_counter() - process_age()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    import torch

    cell = Cell(root, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
