"""Device mesh construction for multi-chip rendering.

The reference is single-GPU (SURVEY.md §2.6: device 0 only, host<->device
memcpy is the only transport). The scaling design here (SURVEY.md §5.8): a
1-D mesh over all devices with the PIXEL-TILE axis sharded, scene + BVH
replicated in each device's memory, and the gradient psum as the only
collective (XLA hands it to NCCL on GPUs). The mesh has no torus shape:
the four H100s of one host are joined all to all by NVLink. For several
hosts, ``initialize_distributed`` wires jax.distributed first; the mesh
then spans every device of every host.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None):
    """Multi-host init (jax.distributed). No-op if single-process.

    Call once at program start on every host; after it ``jax.devices()``
    contains all devices of all hosts. Nothing discovers a cluster by
    itself: pass the coordinator address (``host:port``), the process
    count and this process's id.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )


def make_tile_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over devices; the pixel-tile axis shards across it."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (TILE_AXIS,))


def tile_spec():
    return P(TILE_AXIS)


def replicated_spec():
    return P()


def shard_pixels(mesh: Mesh, arr):
    """Place a pixel-axis array with the tile sharding."""
    return jax.device_put(arr, NamedSharding(mesh, P(TILE_AXIS)))
