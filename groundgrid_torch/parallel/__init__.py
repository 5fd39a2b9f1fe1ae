"""Scaling over devices and processes: a fleet of vehicles stepped in
lock-step over a list of devices (``sharding.py``) and across processes
with ``torch.distributed`` (``multihost.py``); one grid split row-wise over
a mesh (``spatial.py``), with the spiral as an exact band relay
(``spiral_shard.py``)."""

from groundgrid_torch.parallel.spatial import (
    CapturedDetect,
    CapturedSpatialStep,
    GroupMesh,
    LocalMesh,
    ShardedDetect,
    SpatialOutput,
    SpatialStep,
    blocks_from_numpy,
    blocks_to_numpy,
    exchange_halo,
    gather_rows,
    make_sharded_detect,
    make_spatial_step,
    shard_scan,
    spatial_sharding,
    split_rows,
)
from groundgrid_torch.parallel.spiral_shard import (BandRelay, banded_spiral, pack_ring, ring_bands,
                                                    unpack_ring)

__all__ = [
    "CapturedDetect", "CapturedSpatialStep", "GroupMesh", "LocalMesh", "ShardedDetect",
    "SpatialOutput", "SpatialStep", "blocks_from_numpy", "blocks_to_numpy",
    "exchange_halo", "gather_rows", "make_sharded_detect", "make_spatial_step", "shard_scan",
    "spatial_sharding", "split_rows", "BandRelay", "banded_spiral", "pack_ring", "ring_bands",
    "unpack_ring",
]
