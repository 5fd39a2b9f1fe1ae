"""KITTI-operating-point synthetic world (VERDICT r3 'Next round' #1).

A copy of ``groundgrid_tpu/data/kitti_world.py`` on the port's label table,
held to the original bitwise by ``tests/test_torch_shared.py``.

The reference's published numbers come from SemanticKITTI sequence 00
(the reference's ``README.md:56-94``): 4540 urban scans, ~121k pts/scan,
scored at recall 98.70 / precision 96.05 / F1 97.35 / IoUg 94.84, with a
characteristic per-class ground%% profile (road 99.93%% ground, car 5.58%%,
building 2.67%%, vegetation 6.57%%, terrain 93.32%%, fence 11.09%% ...).
The repo's earlier accuracy evidence lives on an adversarial world scoring
~71%% recall -- a different threshold-crossing regime. This module builds an
URBAN world whose *scored* profile lands near the seq-00 table, so
pipeline-vs-golden parity is measured at the reference's own operating
point.

World model (residential street canyon, seq-00-like):
  * straight road along +x with a gentle rolling base terrain and a tiny
    lane crown; lane-marking stripes at the center line;
  * curbed sidewalks; block-structured frontage per side: building rows,
    grass terrain (with short-wavelength roughness -> the ~7%% of terrain
    points the reference misses), parking bays, hedge strips, fences;
  * street trees (trunk + porous canopy), poles, traffic signs;
  * parked cars with realistic ground clearance (the ~5.6%% of car points
    the reference labels ground are the lowest body points);
  * moving cars (label 252) driving the opposite lane -- dynamic objects
    crossing cells between scans;
  * optional rain mode: random ring (beam) dropout + near-field clutter
    labeled outlier/unlabeled;
  * optional mirror reflections below the road (occlusion-march stress).

Drive plans exercise the grid-relocation edge cases end to end: forward
cruise, stop (no-damage early return, GroundGrid.cpp:136-137), REVERSE over
already-mapped street (negative damage regions), and exact half-cell pose
deltas (the grid_map half-away-from-zero snap, AUDIT.md #1).

Everything is plain NumPy on the host: a data source, not compute path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from groundgrid_torch.data.labels import NAME_TO_ID

ROAD = NAME_TO_ID["road"]
PARKING = NAME_TO_ID["parking"]
SIDEWALK = NAME_TO_ID["sidewalk"]
LANE_MARKING = NAME_TO_ID["lane-marking"]
TERRAIN = NAME_TO_ID["terrain"]
OTHER_GROUND = NAME_TO_ID["other-ground"]
CAR = NAME_TO_ID["car"]
MOVING_CAR = NAME_TO_ID["moving-car"]
BUILDING = NAME_TO_ID["building"]
FENCE = NAME_TO_ID["fence"]
VEGETATION = NAME_TO_ID["vegetation"]
TRUNK = NAME_TO_ID["trunk"]
POLE = NAME_TO_ID["pole"]
TRAFFIC_SIGN = NAME_TO_ID["traffic-sign"]
OTHER_OBJECT = NAME_TO_ID["other-object"]
OUTLIER = NAME_TO_ID["outlier"]
UNLABELED = NAME_TO_ID["unlabeled"]

SENSOR_HEIGHT = 1.73  # m above road (KITTI velodyne mount)

# lateral zone widths (m) -- a residential canyon cross-section. Narrow
# European-style street (seq 00 is Karlsruhe residential): ~6 m roadway,
# ~1.8 m sidewalks, frontage (buildings/hedges/gardens) right at the
# sidewalk edge. The near-field beam budget is what sets the class shares:
# beams below -10 deg hit surfaces within ~10 m, so whatever stands at
# 5-8 m lateral (walls, hedges, parked cars) absorbs most of the ring that
# a too-wide cross-section would spend on pavement.
ROAD_HW = 3.0  # road half-width
PARK_W = 2.0  # parking bay width (blocks that have one)
SW_W = 1.9  # sidewalk width
CURB_H = 0.12
BLOCK_LEN = 36.0  # frontage block length along x

# per-side block frontage types
_B_BUILDING, _B_TERRAIN, _B_PARK_BUILDING, _B_HEDGE_TERRAIN, _B_FENCE_TERRAIN = range(5)


@dataclasses.dataclass
class KittiScene:
    seed: int
    # base terrain: gentle rolling sinusoids + tiny grade
    base_amp: np.ndarray  # (K,)
    base_freq: np.ndarray  # (K, 2)
    base_phase: np.ndarray  # (K,)
    grade: tuple
    # grass roughness (applied on terrain zones only)
    rough_amp: np.ndarray  # (K2,)
    rough_freq: np.ndarray  # (K2, 2)
    rough_phase: np.ndarray  # (K2,)
    # frontage blocks: block_types[side(0=-y,1=+y), block_idx]
    block_types: np.ndarray
    block_x0: float
    n_blocks: int
    # static props: (cx, cy, sx, sy, sz, label, z_off, porosity)
    boxes: np.ndarray
    # moving cars: (x0, y, v_mps, sx, sy, sz, z_off) -- position x0 + v*t
    movers: np.ndarray
    reflection_rate: float = 0.0015
    reflection_depth: tuple = (0.5, 2.5)


def _block_type(scene: KittiScene, side: int, x) -> np.ndarray:
    bi = np.clip(((np.asarray(x) - scene.block_x0) // BLOCK_LEN).astype(int),
                 0, scene.n_blocks - 1)
    return scene.block_types[side, bi]


def base_z(scene: KittiScene, x, y):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.zeros_like(x)
    for a, (fx, fy), p in zip(scene.base_amp, scene.base_freq, scene.base_phase):
        z = z + a * np.sin(fx * x + p) * np.cos(fy * y)
    gx, gy = scene.grade
    return z + gx * x + gy * y


def _roughness(scene: KittiScene, x, y):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.zeros_like(x)
    for a, (fx, fy), p in zip(scene.rough_amp, scene.rough_freq, scene.rough_phase):
        z = z + a * np.sin(fx * x + p) * np.sin(fy * y + 0.7 * p)
    return z


def surface(scene: KittiScene, x, y):
    """(z, label) of the ground surface at map (x, y). Vectorized."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = base_z(scene, x, y)
    ay = np.abs(y)
    side = (y > 0).astype(int)
    btype = _block_type(scene, 0, x) * (1 - side) + _block_type(scene, 1, x) * side

    has_park = btype == _B_PARK_BUILDING
    park_outer = ROAD_HW + np.where(has_park, PARK_W, 0.0)
    sw_outer = park_outer + SW_W

    lbl = np.full(x.shape, TERRAIN, dtype=np.int32)
    # beyond sidewalk: grass terrain with roughness (buildings occlude theirs)
    beyond = ay > sw_outer
    z = np.where(beyond, z + CURB_H + _roughness(scene, x, y), z)
    # sidewalk band: curb ramps up over 0.25 m (driveways, worn curbs)
    on_sw = (ay > park_outer) & ~beyond
    curb = CURB_H * np.clip((ay - park_outer) / 0.35, 0.0, 1.0)
    z = np.where(on_sw, z + curb, z)
    lbl = np.where(on_sw, SIDEWALK, lbl)
    # parking bay: road level
    on_park = has_park & (ay > ROAD_HW) & (ay <= park_outer)
    lbl = np.where(on_park, PARKING, lbl)
    # road: tiny crown, dashed center lane marking
    on_road = ay <= ROAD_HW
    z = np.where(on_road, z + 0.015 * (1.0 - np.square(y / ROAD_HW)), z)
    dash = (ay < 0.06) & (np.mod(x, 6.0) < 3.0)
    lbl = np.where(on_road, np.where(dash, LANE_MARKING, ROAD), lbl)
    return z, lbl


def make_kitti_scene(seed: int = 0, length_m: float = 800.0) -> KittiScene:
    rng = np.random.default_rng(seed)
    k = 3
    base_amp = rng.uniform(0.15, 0.45, size=k)
    base_freq = rng.uniform(2 * np.pi / 260.0, 2 * np.pi / 90.0, size=(k, 2))
    base_phase = rng.uniform(0, 2 * np.pi, size=k)
    grade = (rng.uniform(-0.012, 0.012), rng.uniform(-0.006, 0.006))
    k2 = 4
    rough_amp = rng.uniform(0.02, 0.045, size=k2)
    rough_freq = rng.uniform(2 * np.pi / 3.5, 2 * np.pi / 1.2, size=(k2, 2))
    rough_phase = rng.uniform(0, 2 * np.pi, size=k2)

    block_x0 = -120.0
    n_blocks = int(np.ceil((length_m + 240.0) / BLOCK_LEN))
    block_types = rng.choice(
        [_B_BUILDING, _B_TERRAIN, _B_PARK_BUILDING, _B_HEDGE_TERRAIN,
         _B_FENCE_TERRAIN],
        p=[0.50, 0.13, 0.10, 0.14, 0.13], size=(2, n_blocks),
    )

    boxes: list[tuple] = []

    def ground_at(cx, cy):
        z, _ = surface(
            _tmp_scene, np.asarray([cx]), np.asarray([cy])
        )
        return float(z[0])

    # a throwaway scene for ground queries during placement
    _tmp_scene = KittiScene(
        seed=seed, base_amp=base_amp, base_freq=base_freq,
        base_phase=base_phase, grade=grade, rough_amp=rough_amp,
        rough_freq=rough_freq, rough_phase=rough_phase,
        block_types=block_types, block_x0=block_x0, n_blocks=n_blocks,
        boxes=np.zeros((0, 8)), movers=np.zeros((0, 7)),
    )

    for side in (0, 1):
        sgn = -1.0 if side == 0 else 1.0
        for bi in range(n_blocks):
            # per-category child rngs, seeded by (seed, side, block): tuning
            # one prop category (fence density, car counts, ...) leaves every
            # other category's realization bit-identical -- without this,
            # every edit reshuffles the whole street and per-class shares
            # move by many points from rng-stream drift alone
            _ss = np.random.SeedSequence(entropy=(seed, side, bi))
            (r_bld, r_veg, r_grass, r_fence,
             r_tree, r_pole, r_misc, r_car) = map(
                np.random.default_rng, _ss.spawn(8))
            bx = block_x0 + bi * BLOCK_LEN
            bt = block_types[side, bi]
            has_park = bt == _B_PARK_BUILDING
            front = ROAD_HW + (PARK_W if has_park else 0.0) + SW_W

            if bt in (_B_BUILDING, _B_PARK_BUILDING):
                # near-continuous building row with a gap
                gap = r_bld.uniform(3.0, 8.0)
                x_cursor = bx
                while x_cursor < bx + BLOCK_LEN - 4.0:
                    w = r_bld.uniform(9.0, 16.0)
                    depth = r_bld.uniform(9.0, 14.0)
                    h = r_bld.uniform(5.0, 11.0)
                    cx = x_cursor + w / 2
                    cy = sgn * (front + 0.3 + depth / 2)
                    boxes.append((cx, cy, w, depth, h, float(BUILDING), 0.0, 0.0))
                    # plinth/doorstep returns at the wall base (scored
                    # ground within tolerance; README building 2.67%)
                    boxes.append((cx, sgn * (front + 0.25), w, 0.25, 0.14,
                                  float(BUILDING), 0.0, 0.55))
                    if r_bld.random() < 0.35:
                        # facade greenery: porous slab hugging the wall
                        boxes.append((cx, sgn * (front + 0.15),
                                      w * r_bld.uniform(0.5, 0.9), 0.8,
                                      r_bld.uniform(2.2, 4.0), float(VEGETATION),
                                      0.0, 0.45))
                    gapped = r_bld.random() < 0.65
                    if gapped:
                        # front-garden vegetation filling the building gap,
                        # at GROUND level (eye-level returns)
                        gx = x_cursor + w + gap / 2
                        boxes.append((gx, sgn * (front + r_bld.uniform(1.5, 4.0)),
                                      gap, r_bld.uniform(4.0, 10.0),
                                      r_bld.uniform(2.0, 5.0), float(VEGETATION),
                                      0.0, 0.40))
                    x_cursor += w + (gap if gapped else 0.6)
            elif bt in (_B_TERRAIN, _B_HEDGE_TERRAIN, _B_FENCE_TERRAIN):
                # grass with dense ground-level shrubbery and garden trees --
                # the sub-3-m side surfaces that carry KITTI's vegetation
                # share (down-pointing beams can only see eye-level foliage)
                for _ in range(r_veg.integers(6, 11)):
                    cx = bx + r_veg.uniform(2.0, BLOCK_LEN - 2.0)
                    cy = sgn * (front + r_veg.uniform(1.0, 12.0))
                    s = r_veg.uniform(3.0, 8.0)
                    boxes.append((cx, cy, s, s, r_veg.uniform(1.5, 4.0),
                                  float(VEGETATION), 0.0, 0.40))
                # low ground-cover patches: the near-ground foliage that
                # carries seq-00's 6.6% ground-labeled vegetation
                for _ in range(r_veg.integers(4, 8)):
                    cx = bx + r_veg.uniform(2.0, BLOCK_LEN - 2.0)
                    cy = sgn * (front + r_veg.uniform(0.5, 8.0))
                    s = r_veg.uniform(2.0, 5.0)
                    boxes.append((cx, cy, s, s, r_veg.uniform(0.3, 0.7),
                                  float(VEGETATION), 0.0, 0.30))
                # flat groundcover mats (ivy, mown flower beds): essentially
                # AT ground level -> scored ground, GT vegetation. This is
                # the content that lifts vegetation's ground% toward the
                # README's 6.57% (r4 world sat at 2.66%)
                for _ in range(r_veg.integers(4, 8)):
                    cx = bx + r_veg.uniform(2.0, BLOCK_LEN - 2.0)
                    cy = sgn * (front + r_veg.uniform(0.3, 7.0))
                    s = r_veg.uniform(1.5, 3.5)
                    boxes.append((cx, cy, s, s, r_veg.uniform(0.04, 0.12),
                                  float(VEGETATION), 0.0, 0.25))
                # tall-grass clumps, GT label TERRAIN: unmown tufts that the
                # reference misclassifies as obstacles -- the ~7% of terrain
                # points seq-00 scores non-ground (README terrain 93.32%)
                for _ in range(r_grass.integers(3, 6)):
                    cx = bx + r_grass.uniform(2.0, BLOCK_LEN - 2.0)
                    cy = sgn * (front + r_grass.uniform(0.4, 10.0))
                    s = r_grass.uniform(0.8, 2.5)
                    boxes.append((cx, cy, s, s, r_grass.uniform(0.28, 0.60),
                                  float(TERRAIN), 0.0, 0.35))
                for _ in range(r_tree.integers(1, 3)):
                    cx = bx + r_tree.uniform(2.0, BLOCK_LEN - 2.0)
                    cy = sgn * (front + r_tree.uniform(3.0, 14.0))
                    boxes.append((cx, cy, 0.45, 0.45, r_tree.uniform(1.8, 3.0),
                                  float(TRUNK), r_tree.uniform(0.0, 0.1), 0.0))
                if bt == _B_HEDGE_TERRAIN:
                    boxes.append((bx + BLOCK_LEN / 2, sgn * (front + 0.8),
                                  BLOCK_LEN * 0.8, 1.6, r_veg.uniform(1.2, 2.2),
                                  float(VEGETATION), 0.0, 0.30))
                if bt == _B_FENCE_TERRAIN:
                    # fence line as independent ~8.5 m panels, each low
                    # garden fence or tall privacy fence: the mix -- plus
                    # every panel's solid bottom rail and base overgrowth --
                    # carries seq-00's 11.09% ground-scored fence points,
                    # and per-panel randomization keeps the realization
                    # noise of this small-share class down
                    fy = sgn * (front + 0.5)
                    seg_w = BLOCK_LEN * 0.95 / 4
                    for si in range(4):
                        sx_c = bx + BLOCK_LEN * 0.025 + (si + 0.5) * seg_w
                        low = r_fence.random() < 0.3
                        fh = (r_fence.uniform(0.3, 0.5) if low
                              else r_fence.uniform(0.8, 1.3))
                        boxes.append((sx_c, fy, seg_w, 0.12, fh,
                                      float(FENCE), 0.0, 0.45))
                        # base overgrowth (annotated fence in SemanticKITTI)
                        boxes.append((sx_c, fy, seg_w, 0.30, 0.08,
                                      float(FENCE), 0.0, 0.72))
                        # solid bottom rail / kickboard (within tolerance)
                        boxes.append((sx_c, fy, seg_w, 0.14, 0.18,
                                      float(FENCE), 0.0, 0.62))
                    # a second garden-boundary fence deeper into the lot
                    if r_fence.random() < 0.5:
                        fy2 = sgn * (front + r_fence.uniform(6.0, 11.0))
                        boxes.append((bx + BLOCK_LEN / 2, fy2,
                                      BLOCK_LEN * 0.8, 0.12,
                                      r_fence.uniform(0.35, 0.9),
                                      float(FENCE), 0.0, 0.3))
                        boxes.append((bx + BLOCK_LEN / 2, fy2,
                                      BLOCK_LEN * 0.8, 0.14, 0.18,
                                      float(FENCE), 0.0, 0.62))

            # front-yard fence at the sidewalk edge of some building rows
            # (row houses with fenced forecourts): raises the fence share
            # toward seq-00's 3.2% and, via the solid bottom rail, its
            # ground-scored slice
            if bt in (_B_BUILDING, _B_PARK_BUILDING) and r_fence.random() < 0.45:
                fy = sgn * (front + 0.15)
                fh = (r_fence.uniform(0.3, 0.5) if r_fence.random() < 0.3
                      else r_fence.uniform(0.7, 1.1))
                boxes.append((bx + BLOCK_LEN / 2, fy, BLOCK_LEN * 0.85,
                              0.12, fh, float(FENCE), 0.0, 0.55))
                boxes.append((bx + BLOCK_LEN / 2, fy, BLOCK_LEN * 0.85,
                              0.14, 0.18, float(FENCE), 0.0, 0.60))
                boxes.append((bx + BLOCK_LEN / 2, fy, BLOCK_LEN * 0.85,
                              0.26, 0.08, float(FENCE), 0.0, 0.68))

            # planted verge strips on the sidewalk outer edge: ankle-high
            # municipal planting, fully visible (nothing stands between
            # them and the sensor) -- the reliable slice of seq-00's 6.57%
            # ground-scored vegetation
            for _ in range(int(r_veg.integers(1, 3))):
                cx = bx + r_veg.uniform(2.0, BLOCK_LEN - 2.0)
                boxes.append((cx, sgn * (front - 0.45),
                              r_veg.uniform(2.0, 5.0), 0.7,
                              r_veg.uniform(0.04, 0.14),
                              float(VEGETATION), 0.0, 0.2))

            # street trees along the sidewalk outer edge (fewer where
            # building rows need their walls visible)
            in_building = bt in (_B_BUILDING, _B_PARK_BUILDING)
            n_trees = int(r_tree.integers(1, 3)) if in_building else int(r_tree.integers(2, 5))
            for _ in range(n_trees):
                cx = bx + r_tree.uniform(2.0, BLOCK_LEN - 2.0)
                cy = sgn * (front - 0.4)
                boxes.append((cx, cy, 0.35, 0.35, r_tree.uniform(2.5, 3.5),
                              float(TRUNK), r_tree.uniform(0.0, 0.08), 0.0))
                cs = r_tree.uniform(4.0, 6.5)
                boxes.append((cx, cy, cs, cs, r_tree.uniform(3.0, 5.0),
                              float(VEGETATION), r_tree.uniform(2.2, 3.2), 0.45))

            # poles + signs
            for _ in range(int(r_pole.integers(1, 3))):
                cx = bx + r_pole.uniform(2.0, BLOCK_LEN - 2.0)
                cy = sgn * (ROAD_HW + (PARK_W if has_park else 0.0) + 0.5)
                boxes.append((cx, cy, 0.14, 0.14, r_pole.uniform(3.5, 6.0),
                              float(POLE), 0.0, 0.0))
                if r_pole.random() < 0.5:
                    boxes.append((cx, cy, 0.65, 0.08, 0.65,
                                  float(TRAFFIC_SIGN), r_pole.uniform(2.0, 2.6), 0.0))
            # misc street furniture (bins, boxes)
            if r_misc.random() < 0.75:
                cx = bx + r_misc.uniform(2.0, BLOCK_LEN - 2.0)
                cy = sgn * (front - r_misc.uniform(0.6, 1.5))
                boxes.append((cx, cy, r_misc.uniform(0.6, 1.4), r_misc.uniform(0.6, 1.2),
                              r_misc.uniform(0.7, 1.3), float(OTHER_OBJECT),
                              0.0, 0.0))
            # low curbside clutter (pallets, planters, speed bumps): most of
            # an 0.2-0.4 m object's returns sit within the obstacle
            # tolerance -> scored ground; lifts other-object toward the
            # README's 10.41% (r4 world sat at 5.89%)
            for _ in range(int(r_misc.integers(1, 4))):
                if r_misc.random() >= 0.22:
                    continue
                cx = bx + r_misc.uniform(2.0, BLOCK_LEN - 2.0)
                cy = sgn * (front - r_misc.uniform(0.3, 1.2))
                boxes.append((cx, cy, r_misc.uniform(0.5, 1.1), r_misc.uniform(0.4, 0.8),
                              r_misc.uniform(0.08, 0.30), float(OTHER_OBJECT),
                              0.0, 0.0))

            # parked cars: in parking bays, or at the road edge elsewhere
            n_cars = int(r_car.integers(3, 6)) if has_park else int(r_car.integers(0, 2))
            for _ in range(n_cars):
                cx = bx + r_car.uniform(2.5, BLOCK_LEN - 2.5)
                cy = sgn * (ROAD_HW + (PARK_W / 2 if has_park else 0.4))
                cyy = cy + r_car.uniform(-0.3, 0.3)
                sx, sy = r_car.uniform(3.8, 4.8), r_car.uniform(1.7, 1.9)
                clr = r_car.uniform(0.12, 0.22)
                boxes.append((cx, cyy, sx, sy,
                              r_car.uniform(1.15, 1.45), float(CAR),
                              clr, 0.0))
                # tires + under-body returns filling the clearance gap:
                # sparse, AT ground level -> the ~5.6% of car points seq-00
                # scores ground (lowest body/wheel returns)
                boxes.append((cx, cyy, sx * 0.9, sy * 0.85, clr,
                              float(CAR), 0.0, 0.72))

    # moving cars in the opposite lane (and a couple in ours)
    movers = []
    for _ in range(1):
        lane = rng.choice([-1.0, 1.0])
        x0 = rng.uniform(-60.0, length_m)
        v = -rng.uniform(10.0, 16.0) if lane > 0 else rng.uniform(10.0, 16.0)
        movers.append((x0, lane * 1.6 + rng.uniform(-0.2, 0.2), v,
                       rng.uniform(3.8, 4.8), rng.uniform(1.7, 1.9),
                       rng.uniform(1.15, 1.45), rng.uniform(0.20, 0.28)))

    return KittiScene(
        seed=seed, base_amp=base_amp, base_freq=base_freq,
        base_phase=base_phase, grade=grade, rough_amp=rough_amp,
        rough_freq=rough_freq, rough_phase=rough_phase,
        block_types=block_types, block_x0=block_x0, n_blocks=n_blocks,
        boxes=np.array(boxes, dtype=np.float64),
        movers=np.array(movers, dtype=np.float64),
    )


def _wrap_pi(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def render_kitti_scan(
    scene: KittiScene,
    t_map_velo: np.ndarray,
    t_s: float = 0.0,
    n_beams: int = 64,
    n_azimuth: int = 1800,
    max_range: float = 80.0,
    noise: float = 0.012,
    rain_rate: float = 0.0,
    seed: int = 0,
):
    """Ray-cast one scan; returns (points_velo (P,3) f32, labels (P,) i32).

    ``t_s``: sequence time in seconds (moving-car positions). ``rain_rate``:
    0 disables; else the fraction of beams degraded this scan (each degraded
    beam loses ~60%% of returns) plus sparse mid-range clutter points.
    """
    rng = np.random.default_rng(seed)
    T = np.asarray(t_map_velo, dtype=np.float64)
    o = T[:3, 3]
    R = T[:3, :3]

    if n_beams == 64:
        # HDL-64E two-block profile: upper 32 lasers ~1/3 deg apart
        # (+2..-8.33), lower 32 ~1/2 deg (-8.83..-24.33) -- more shallow
        # beams (mid-range returns) than a uniform spread would give
        elev = np.deg2rad(np.concatenate([
            np.linspace(2.0, -8.33, 32), np.linspace(-8.83, -24.33, 32),
        ]))
    else:
        elev = np.deg2rad(np.linspace(2.0, -24.8, n_beams))
    azim = np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(azim), np.sin(azim)
    d_sensor = np.stack(
        [ce[:, None] * ca[None, :], ce[:, None] * sa[None, :],
         np.broadcast_to(se[:, None], (n_beams, n_azimuth))], axis=-1,
    ).reshape(-1, 3)
    d = d_sensor @ R.T
    rings = np.broadcast_to(
        np.arange(n_beams, dtype=np.int32)[:, None], (n_beams, n_azimuth)
    ).reshape(-1)

    n_rays = d.shape[0]
    # ground intersection by fixed-point iteration (gentle slopes + curb)
    down = d[:, 2] < -1e-3
    z0, _ = surface(scene, o[0], o[1])
    with np.errstate(invalid="ignore", divide="ignore"):
        t_est = np.where(down, (z0 - o[2]) / np.where(down, d[:, 2], -1.0), np.inf)
        for _ in range(4):
            px = o[0] + t_est * d[:, 0]
            py = o[1] + t_est * d[:, 1]
            zs, _ = surface(scene, px, py)
            t_est = np.where(down, (zs - o[2]) / d[:, 2], np.inf)
    ok = down & (t_est > 0.5) & (t_est < max_range)
    t_hit = np.where(ok, t_est, np.inf)
    gx = o[0] + t_hit * d[:, 0]
    gy = o[1] + t_hit * d[:, 1]
    with np.errstate(invalid="ignore"):
        _, glbl = surface(
            scene,
            np.nan_to_num(gx, posinf=0.0, neginf=0.0),
            np.nan_to_num(gy, posinf=0.0, neginf=0.0),
        )
    lbl = np.where(np.isfinite(t_hit), glbl, 0).astype(np.int32)
    # grazing-incidence dropout on asphalt: distant road returns mostly do
    # not come back on real HDL-64E data (low-reflectivity surface at
    # near-zero incidence) -- this is what keeps seq-00's road share at
    # ~17% of points instead of the geometric ~40%
    g_range = np.where(np.isfinite(t_hit), t_hit, 0.0)
    graze = np.isin(lbl, (ROAD, PARKING, LANE_MARKING)) & (
        rng.random(n_rays) < np.clip((g_range - 12.0) / 40.0, 0.0, 0.94)
    )
    t_hit = np.where(graze, np.inf, t_hit)
    lbl = np.where(graze, 0, lbl)

    # boxes: static props + movers at their time-t positions
    ray_phi = np.arctan2(d[:, 1], d[:, 0])
    boxes = scene.boxes
    if len(scene.movers):
        mv = scene.movers
        mb = np.stack([
            mv[:, 0] + mv[:, 2] * t_s, mv[:, 1], mv[:, 3], mv[:, 4], mv[:, 5],
            np.full(len(mv), float(MOVING_CAR)), mv[:, 6], np.zeros(len(mv)),
        ], axis=1)
        boxes = np.concatenate([boxes, mb], axis=0) if len(boxes) else mb

    for box in boxes:
        cx, cy, sx, sy, sz, blabel, z_off, porosity = box
        dx, dy = cx - o[0], cy - o[1]
        dist = np.hypot(dx, dy)
        if dist - 0.5 * np.hypot(sx, sy) > max_range:
            continue
        zb = base_z(scene, cx, cy)
        # frontage objects sit on their zone's surface: curb plus -- beyond
        # the sidewalk -- the grass roughness field. Ignoring roughness here
        # floats/sinks near-ground props by up to +-0.15 m, which washes out
        # every deliberately-within-tolerance prop (mats, fence rails)
        on_grass = abs(cy) > ROAD_HW + 0.5
        z0b = zb + (CURB_H if on_grass else 0.0) + z_off
        if on_grass:
            z0b += float(_roughness(scene, np.asarray([cx]), np.asarray([cy]))[0])
        lo = np.array([cx - sx / 2, cy - sy / 2, z0b])
        hi = np.array([cx + sx / 2, cy + sy / 2, z0b + sz])
        # azimuth-window culling: only rays pointing at the box
        half_span = np.arctan2(0.5 * np.hypot(sx, sy), max(dist, 1.0)) + 0.02
        if dist < 0.75 * np.hypot(sx, sy):
            idx = np.arange(n_rays)
        else:
            phi = np.arctan2(dy, dx)
            idx = np.nonzero(np.abs(_wrap_pi(ray_phi - phi)) <= half_span)[0]
            if idx.size == 0:
                continue
        ds = d[idx]
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (lo[None, :] - o[None, :]) / ds
            t2 = (hi[None, :] - o[None, :]) / ds
        tmin = np.nanmax(np.minimum(t1, t2), axis=1)
        tmax = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (tmax >= tmin) & (tmax > 0) & (tmin < max_range) & (tmin > 0.5)
        if porosity > 0.0:
            hit &= rng.random(idx.size) >= porosity
        closer = hit & (tmin < t_hit[idx])
        sub = idx[closer]
        t_hit[sub] = tmin[closer]
        lbl[sub] = np.int32(blabel)

    # mirror reflections below the road (multipath; GT label "outlier")
    refl_pts = refl_lbl = None
    if scene.reflection_rate > 0.0:
        is_ground_hit = np.isfinite(t_hit) & np.isin(
            lbl, (ROAD, SIDEWALK, PARKING, LANE_MARKING)
        )
        pick = is_ground_hit & (rng.random(n_rays) < scene.reflection_rate)
        if pick.any():
            k = int(pick.sum())
            depth = rng.uniform(*scene.reflection_depth, k)
            p = o[None, :] + t_hit[pick, None] * d[pick]
            p = p.copy()
            # seq-00's "outlier" class scores ~57% ground / 43% nonground:
            # mirror multipath lands BELOW the surface (classified ground),
            # sensor glitches land ABOVE it (classified nonground) -- mix
            # both so the class profile matches
            above = rng.random(k) < 0.42
            p[:, 2] += np.where(above, rng.uniform(0.6, 4.0, k), -2.0 * depth)
            refl_pts, refl_lbl = p, np.full(len(p), OUTLIER, dtype=np.int32)

    # annotation gaps: SemanticKITTI leaves ~1.3% of seq-00's points
    # unlabeled (id 0), mostly on object boundaries/clutter, a small slice
    # on ground surfaces -- the README scores that class 11.26% ground.
    # Relabel a biased sample (geometry untouched): object-class points at
    # ~2.1%, ground-class points at ~0.26%, which lands share ~1.3% with
    # ~7.6% drawn from ground classes (predicted-ground share ~11%).
    ground_ids = (ROAD, PARKING, SIDEWALK, LANE_MARKING, TERRAIN, OTHER_GROUND)
    is_gnd = np.isin(lbl, ground_ids)
    hit_any = np.isfinite(t_hit)
    p_gap = np.where(is_gnd, 0.0022, 0.021)
    gap = hit_any & (rng.random(n_rays) < p_gap)
    lbl = np.where(gap, UNLABELED, lbl)

    keep = np.isfinite(t_hit)
    if rain_rate > 0.0:
        # degraded beams lose most returns (wet-surface absorption)
        bad_beam = rng.random(n_beams) < rain_rate
        degraded = bad_beam[rings]
        keep &= ~(degraded & (rng.random(n_rays) < 0.6))
    t_final = t_hit[keep] + rng.normal(0, noise, int(keep.sum()))
    pts_map = o[None, :] + t_final[:, None] * d[keep]
    out_lbl = lbl[keep]

    if rain_rate > 0.0:
        # sparse airborne clutter, mid-range, above the road
        n_cl = int(rng.integers(100, 400))
        r = rng.uniform(4.0, 25.0, n_cl)
        phi = rng.uniform(0, 2 * np.pi, n_cl)
        cz = o[2] + rng.uniform(-1.0, 2.5, n_cl)
        cl = np.stack([o[0] + r * np.cos(phi), o[1] + r * np.sin(phi), cz], 1)
        pts_map = np.concatenate([pts_map, cl], axis=0)
        out_lbl = np.concatenate(
            [out_lbl, np.full(n_cl, UNLABELED, dtype=np.int32)]
        )
    if refl_pts is not None:
        pts_map = np.concatenate([pts_map, refl_pts], axis=0)
        out_lbl = np.concatenate([out_lbl, refl_lbl])

    # annotation bleed around parked cars: SemanticKITTI paints the road
    # returns hugging a car's footprint as 'car' (the ~5.6% of car points
    # seq-00 scores ground). Relabel the <=0.35 m perimeter ring.
    car_boxes = [b for b in boxes if b[5] in (float(CAR), float(MOVING_CAR))
                 and b[7] == 0.0]
    if car_boxes and len(pts_map):
        zsurf = None
        for cx, cy, sx, sy, sz, blabel, z_off, _ in car_boxes:
            if np.hypot(cx - o[0], cy - o[1]) > max_range + 5.0:
                continue
            near = (np.abs(pts_map[:, 0] - cx) < sx / 2 + 0.2) & (
                np.abs(pts_map[:, 1] - cy) < sy / 2 + 0.2)
            if not near.any():
                continue
            if zsurf is None:
                zsurf = np.full(len(pts_map), np.nan)
            idx = np.nonzero(near)[0]
            zs_n = zsurf[idx]
            miss = np.isnan(zs_n)
            if miss.any():
                zv, _ = surface(scene, pts_map[idx[miss], 0],
                                pts_map[idx[miss], 1])
                zs_n[miss] = zv
                zsurf[idx] = zs_n
            low = pts_map[idx, 2] - zs_n < 0.10
            pick = idx[low & (rng.random(idx.size) < 0.12)]
            out_lbl[pick] = np.int32(blabel)

    pts_velo = (pts_map - o[None, :]) @ R
    return pts_velo.astype(np.float32), out_lbl


def _pose_at(scene: KittiScene, x: float, y: float, yaw: float) -> np.ndarray:
    z, _ = surface(scene, np.asarray([x]), np.asarray([y]))
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1.0]]
    T[:3, 3] = (x, y, float(z[0]) + SENSOR_HEIGHT)
    return T


def drive_plan(n_scans: int, step_m: float = 1.2, resolution: float = 0.33,
               variant: str = "city") -> list[tuple[str, float]]:
    """A list of (mode, dx) per scan. Modes: cruise/stop/reverse/halfcell.

    ``city``: ~70%% forward cruise, a stop segment (no-damage early-return),
    a REVERSE segment back over mapped street (negative damage), an exact
    half-cell-delta segment (grid_map index-shift snap rule), then cruise.
    ``forward``: pure cruise (operating-point measurement).
    ``loop``: seq-00-length legs — out-and-back traversals of the SAME
    ~900 m street (x stays bounded), each leg with the city events, so a
    4540-scan drive closes the loop over previously-mapped-then-forgotten
    terrain every ~750 scans (the long-horizon regime of
    the reference README.md:58's 4540-cloud evaluation).
    """
    if variant == "forward":
        return [("cruise", step_m)] * n_scans
    if variant == "loop":
        plan = []
        leg = 0
        while len(plan) < n_scans:
            s = step_m if leg % 2 == 0 else -step_m
            plan += [("cruise", s)] * 300
            plan += [("stop", 0.0)] * 4
            plan += [("halfcell", resolution / 2.0)] * 8
            plan += [("reverse", -0.8 * s)] * 30
            plan += [("cruise", s)] * 330
            plan += [("cruise", 1.5 * s)] * 80
            leg += 1
        return plan[:n_scans]
    plan: list[tuple[str, float]] = []
    i = 0
    while len(plan) < n_scans:
        seg = i % 6
        if seg in (0, 1, 4):
            plan += [("cruise", step_m)] * 60
        elif seg == 2:
            plan += [("stop", 0.0)] * 4
            plan += [("halfcell", resolution / 2.0)] * 8
        elif seg == 3:
            plan += [("reverse", -0.8 * step_m)] * 30
        else:
            plan += [("cruise", 1.6 * step_m)] * 40
        i += 1
    return plan[:n_scans]


def kitti_sequence(
    n_scans: int,
    seed: int = 0,
    n_beams: int = 64,
    n_azimuth: int = 1800,
    step_m: float = 1.2,
    variant: str = "city",
    rain_rate: float = 0.0,
    resolution: float = 0.33,
    max_range: float = 80.0,
):
    """Yield (points_velo, labels, t_map_velo) at the KITTI operating point.

    ``variant``: 'forward' = pure cruise; 'city' adds stop, reverse and
    exact-half-cell segments (drive_plan). Half-cell steps are emitted
    relative to a replica of the engine's center recurrence so the pose
    delta over the CURRENT grid center is exactly resolution/2 in f64 --
    landing precisely on the half-away-from-zero snap boundary
    (grid_map getIndexShiftFromPositionShift; AUDIT.md #1).
    """
    # loop variant stays on one ~900 m street (bounded x); others march on
    length = (900.0 if variant == "loop"
              else max(400.0, n_scans * step_m * 0.8))
    scene = make_kitti_scene(seed, length_m=length)
    plan = drive_plan(n_scans, step_m, resolution, variant)
    x = 0.0
    # engine center recurrence replica (golden.py update_odom)
    center_x = None
    for k, (mode, dx) in enumerate(plan):
        if mode == "halfcell":
            # exact half-cell offset from the engine's tracked center
            x = (center_x if center_x is not None else x) + resolution / 2.0
        else:
            x = x + dx
        y = 0.6 * np.sin(0.01 * x)
        yaw = np.arctan2(0.6 * 0.01 * np.cos(0.01 * x), 1.0)
        if mode == "reverse":
            pass  # driving backwards: keep forward heading
        T = _pose_at(scene, x, y, yaw)
        # replicate the center recurrence (x axis; y analogous but unused)
        if center_x is None:
            center_x = float(T[0, 3])
        else:
            dc = (float(T[0, 3]) - center_x) / resolution
            kk = np.sign(dc) * np.floor(abs(dc) + 0.5)
            center_x = center_x + float(kk) * resolution
        pts, lbl = render_kitti_scan(
            scene, T, t_s=k * 0.1, n_beams=n_beams, n_azimuth=n_azimuth,
            max_range=max_range, rain_rate=rain_rate, seed=seed + 5000 + k,
        )
        yield pts, lbl, T
