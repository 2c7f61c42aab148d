"""Device-mesh helpers for campaign-mode sharding.

The reference has no distributed execution at all (SURVEY.md section 2:
single process, single thread). Campaign mode is our addition:
a 1-D mesh over the 'tile' axis, batches of whole HLS tiles data-parallel
across devices, with collectives only for campaign-level statistics.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = 'tile'


def make_tile_mesh(devices=None):
    """1-D mesh over all (or the given) devices, axis name 'tile'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (TILE_AXIS,))


SPACE_AXIS = 'space'


def make_tile_space_mesh(n_tile, n_space, devices=None):
    """2-D mesh ('tile', 'space'): data-parallel over tile batches and
    spatially sharded over tile rows (halo-exchange parallelism)."""
    if devices is None:
        devices = jax.devices()
    if n_tile * n_space != len(devices):
        raise ValueError(f'{n_tile}x{n_space} mesh needs '
                         f'{n_tile * n_space} devices, have '
                         f'{len(devices)}')
    arr = np.array(devices).reshape(n_tile, n_space)
    return Mesh(arr, (TILE_AXIS, SPACE_AXIS))


def tile_sharding(mesh):
    """Sharding for [B, H, W] arrays: batch split across the tile axis."""
    return NamedSharding(mesh, P(TILE_AXIS))


def replicated_sharding(mesh):
    return NamedSharding(mesh, P())
