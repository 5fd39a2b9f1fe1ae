"""Throwaway cells at a size the CPU runs in seconds, written into a
directory laid out as the repository is (``BENCHMARK.json`` and
``portbench/{configs,traffic,checks,metrics}``)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

GROUNDGRID = {
    "point_count_cell_variance_threshold": 10, "max_ring": 1024,
    "groundpatch_detection_minimum_threshold": 0.01, "distance_factor": 0.0001,
    "minimum_distance_factor": 0.0005, "miminum_point_height_threshold": 0.3,
    "minimum_point_height_obstacle_threshold": 0.1, "outlier_tolerance": 0.1,
    "ground_patch_detection_minimum_point_count_threshold": 0.25,
    "patch_size_change_distance": 20.0, "occupied_cells_decrease_factor": 5.0,
    "occupied_cells_point_count_factor": 20.0, "min_outlier_detection_ground_confidence": 1.25,
    "thread_count": 8, "dimension": 16.0, "resolution": 0.5,
    "vertical_point_ang_dist": 0.0034906585, "min_dist_squared": 12.0, "max_points": 4096,
    "ray_steps": 24, "max_outlier_candidates": 512, "march_chunk": 128, "border_drop": True,
    "use_pallas": None, "sorted_scans": False, "sorted_fallback_check": True,
    "wire_format": False, "fused_detect": False, "stale_pose_reuse": False,
}
SORTED = dict(GROUNDGRID, sorted_scans=True)
SENSOR = {"model": "tiny", "beams": 16, "azimuths": 256, "elevation_max_deg": 2.0,
          "elevation_min_deg": -24.8, "max_range_m": 20.0, "range_noise_m": 0.01,
          "rate_hz": 10}
TRAFFIC = {"vehicles": 1, "phase_step": 0, "drive_scans": 4, "pool_scans": 4, "step_m": 1.0,
           "scene": {"n_boxes": 6, "extent": 30.0, "road_halfwidth": 6.0},
           "offset": {"xy_m": [-5.0, 5.0], "z_m": [-1.0, 1.0]}, "check": {"positions": 2}}
LIMITS = {"point_mismatch": 0.0002, "layer_mismatch": 0.01,
          "center_off": 0}


def write(root: Path, extra_metric: str | None = None) -> Path:
    """A tiny copy of the benchmark's layout under ``root``: the config
    ``tiny``, the traffic mixes ``tinyfleet`` (4 vehicles), ``tinyfleet2`` (4
    vehicles on two CPU "cards", 2 a card), ``tinylive`` and ``tinyreplay``,
    one cell each; the sorted-scan config ``tiny-sorted`` under
    ``tinyfleet-sorted`` (``tinyfleet``'s mix, its drives prepared); and the
    repository's metric readers (plus ``extra_metric``'s reader source as
    ``tiny_metric``, if given)."""
    root = Path(root)
    base = root / "portbench"
    for d in ("configs", "traffic", "checks", "metrics"):
        (base / d).mkdir(parents=True, exist_ok=True)
    for name, params in (("tiny", GROUNDGRID), ("tiny-sorted", SORTED)):
        (base / "configs" / f"{name}.json").write_text(json.dumps(
            {"groundgrid": params, "sensor": SENSOR, "reduced": []}))
    fleet = dict(TRAFFIC, loop="fleet", vehicles=4, phase_step=2)
    mixes = {"tinyfleet": ("tiny", fleet),
             "tinyfleet2": ("tiny", dict(fleet, cards=2)),
             "tinylive": ("tiny", dict(TRAFFIC, loop="live")),
             "tinyreplay": ("tiny", dict(TRAFFIC, loop="replay", pipeline_depth=2)),
             "tinyfleet-sorted": ("tiny-sorted", fleet)}
    for name, (conf, t) in mixes.items():
        (base / "traffic" / f"{name}.json").write_text(json.dumps(t))
        limits = dict(LIMITS)
        if t.get("cards", 1) > 1:
            # the fleet over cards also holds its summary to the kept outputs
            limits["summary_off"] = 0
        if conf == "tiny-sorted":
            limits["fallbacks_off"] = 0
        (base / "checks" / f"{name}.{conf}.json").write_text(json.dumps({"limits": limits}))
    for f in (REPO / "portbench" / "metrics").glob("*.py"):
        shutil.copy(f, base / "metrics" / f.name)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["configs"] = [{"name": name, "source": "test", "file": f"portbench/configs/{name}.json",
                         "reduced": [], "why": "test"} for name in ("tiny", "tiny-sorted")]
    bench["workloads"] = [{"name": f"{m}.{conf}", "config": conf, "traffic": m,
                           "chips": t.get("cards", 1), "why": "test"}
                          for m, (conf, t) in mixes.items()]
    rename = {"live.hdl64-1200": "tinylive.tiny", "fleet64.hdl64-364": "tinyfleet.tiny",
              "replay.hdl64-1200": "tinyreplay.tiny", "fleet256x4.hdl64-364": "tinyfleet2.tiny",
              "fleet64-sorted.hdl64-364-sorted": "tinyfleet-sorted.tiny-sorted"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    if extra_metric is not None:
        (base / "metrics" / "tiny_metric.py").write_text(extra_metric)
        bench["per_layer"].append({"name": "tiny_metric", "unit": "ms", "better": "lower",
                                   "source": "host_clock", "layer": "runtime",
                                   "moves": "scans_per_s.vehicle"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
