"""SemanticKITTI label taxonomy.

A copy of ``groundgrid_tpu/data/labels.py``, held to it by
``tests/test_torch_shared.py``.

Vendored from the reference's ``cfg/semantic-kitti-all.yaml`` (itself the
standard semantic-kitti-api mapping) so the evaluation harness needs no YAML
file at runtime. Ids are the raw semantic ids (lower 16 bits of a .label
word, ``scripts/kitti_data_publisher.py:156-161``).
"""

from __future__ import annotations

LABELS: dict[int, str] = {
    0: "unlabeled",
    1: "outlier",
    10: "car",
    11: "bicycle",
    13: "bus",
    15: "motorcycle",
    16: "on-rails",
    18: "truck",
    20: "other-vehicle",
    30: "person",
    31: "bicyclist",
    32: "motorcyclist",
    40: "road",
    44: "parking",
    48: "sidewalk",
    49: "other-ground",
    50: "building",
    51: "fence",
    52: "other-structure",
    60: "lane-marking",
    70: "vegetation",
    71: "trunk",
    72: "terrain",
    80: "pole",
    81: "traffic-sign",
    99: "other-object",
    252: "moving-car",
    253: "moving-bicyclist",
    254: "moving-person",
    255: "moving-motorcyclist",
    256: "moving-on-rails",
    257: "moving-bus",
    258: "moving-truck",
    259: "moving-other-vehicle",
}

NAME_TO_ID = {v: k for k, v in LABELS.items()}

MAX_LABEL_ID = 260  # dense-array bound

# Ground-truth groupings exactly as the reference evaluator defines them
# (scripts/eval_groundpoint_classifier.py:74-78). Vegetation is deliberately
# in *neither* list: it is excluded from precision/recall/F1/accuracy/IoUg.
GROUND_LABELS = ["road", "sidewalk", "parking", "lane-marking"]
ADDITIONAL_GROUND_LABELS = ["other-ground", "terrain"]
NON_GROUND_LABELS = [
    "bicycle", "moving-bicyclist", "motorcycle", "moving-motorcyclist",
    "person", "moving-person", "traffic-sign", "car", "moving-car",
    "motorcyclist", "bicyclist", "truck", "moving-truck", "building", "fence",
    "trunk", "pole", "bus", "on-rails", "other-vehicle", "other-structure",
    "other-object", "moving-on-rails", "moving-bus", "moving-other-vehicle",
]

GROUND_IDS = [NAME_TO_ID[n] for n in GROUND_LABELS]
ADDITIONAL_GROUND_IDS = [NAME_TO_ID[n] for n in ADDITIONAL_GROUND_LABELS]
NON_GROUND_IDS = [NAME_TO_ID[n] for n in NON_GROUND_LABELS]
ALL_GROUND_IDS = GROUND_IDS + ADDITIONAL_GROUND_IDS

# BGR color map (cfg/semantic-kitti-all.yaml color_map) for visualization.
COLOR_MAP_BGR: dict[int, tuple[int, int, int]] = {
    0: (0, 0, 0), 1: (0, 0, 255), 10: (245, 150, 100), 11: (245, 230, 100),
    13: (250, 80, 100), 15: (150, 60, 30), 16: (255, 0, 0), 18: (180, 30, 80),
    20: (255, 0, 0), 30: (30, 30, 255), 31: (200, 40, 255), 32: (90, 30, 150),
    40: (255, 0, 255), 44: (255, 150, 255), 48: (75, 0, 75), 49: (75, 0, 175),
    50: (0, 200, 255), 51: (50, 120, 255), 52: (0, 150, 255), 60: (170, 255, 150),
    70: (0, 175, 0), 71: (0, 60, 135), 72: (80, 240, 150), 80: (150, 240, 255),
    81: (0, 0, 255), 99: (255, 255, 50), 252: (245, 150, 100), 253: (200, 40, 255),
    254: (30, 30, 255), 255: (90, 30, 150), 256: (255, 0, 0), 257: (250, 80, 100),
    258: (180, 30, 80), 259: (255, 0, 0),
}
