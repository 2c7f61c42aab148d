"""Campaign mode: batched multi-tile processing sharded across devices.

This subsystem has no reference counterpart (the reference processes one
tile per process, SURVEY.md section 2); it is the scale-out path demanded
by BASELINE.json config 5 ("100+ tiles sharded across chips"):

- a 1-D device mesh over the 'tile' axis; tile batches [B, H, W] are
  sharded on B with shard_map, so each device runs the identical fused
  chain on its local tiles and the only cross-device communication is a
  psum of the campaign statistics;
- a host I/O pipeline: a reader thread pool prefetches and decodes the
  next batch of HLS tiles while the device computes the current one
  (double buffering), and a writer pool encodes finished COGs;
- a JSON manifest of per-tile status with retry, giving failure detection
  and checkpoint/resume semantics for long campaigns (the reference has
  none, SURVEY.md section 5).
"""

import contextlib
import json
import logging
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from proteus_jax.core import constants as C
from proteus_jax.models.dswx import masking
from proteus_jax.models.dswx.chain import DswxChainConfig, dswx_chain
from proteus_jax.parallel.mesh import TILE_AXIS, make_tile_mesh

logger = logging.getLogger('dswx_hls')


class StageTimes:
    """Cumulative wall-clock per pipeline stage (thread-safe).

    Enabled by PROTEUS_STAGE_TIMES=1; CampaignRunner.run() returns
    the table under stats['stage_seconds']. Stage seconds are summed
    across pool threads, so they measure CORE-seconds of occupancy (plus
    in-stage waiting, e.g. d2h transfer time inside 'd2h_*'), not
    wall-clock.
    """

    def __init__(self):
        self.enabled = os.environ.get('PROTEUS_STAGE_TIMES') == '1'
        self._lock = threading.Lock()
        self.totals = {}

    @contextlib.contextmanager
    def stage(self, name):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                cur = self.totals.setdefault(name, [0.0, 0])
                cur[0] += dt
                cur[1] += 1

    def reset(self):
        with self._lock:
            self.totals = {}

    def table(self):
        return {k: {'seconds': round(v[0], 2), 'calls': v[1]}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1][0])}


STAGE_TIMES = StageTimes()


def pack_bits_device(x):
    """(h, w) 0/1 uint8 -> (h, ceil(w/8)) uint8 bit-packing on device
    (little bit order, matching np.unpackbits(bitorder='little'))."""
    h, w = x.shape
    pad = (-w) % 8
    xp = jnp.pad(x.astype(jnp.int32), ((0, 0), (0, pad)))
    xp = xp.reshape(h, -1, 8)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.int32)
    return (xp * weights).sum(-1).astype(jnp.uint8)


def unpack_bits(packed, width):
    """Invert pack_bits_device: (h, ceil(w/8)) uint8 -> (h, w) 0/1."""
    return np.unpackbits(np.asarray(packed), axis=1,
                         bitorder='little')[:, :width]


def _cast_scaled_bands(bands, scales, offsets):
    """On-device ``scale * (float32(band) - offset)`` for a [B, H, W]
    band tuple and [B, 6] per-tile scale/offset vectors: the reference's
    host cast (dswx_hls.py:2298-2302) as IEEE float32 subtract and
    multiply, which are correctly rounded on every backend."""
    return tuple(scales[:, j, None, None]
                 * (x.astype(jnp.float32) - offsets[:, j, None, None])
                 for j, x in enumerate(bands))


def make_campaign_step(config: DswxChainConfig, mesh,
                       compute_browse=False, with_ocean=False,
                       with_shadow=False, with_landcover=False,
                       float_inputs=False, device_scale=False):
    """Build the sharded multi-tile step.

    The returned function maps batched [B, H, W] band/fmask/invalid arrays
    (plus optional ocean/shadow/landcover mask batches, B sharded over the
    mesh's tile axis) to per-tile output layers (same sharding) plus
    replicated campaign totals (psum over the tile axis).

    ``float_inputs=True`` is the scaled-reflectance campaign: bands are
    float32 (ingest applied scale/offset) and the chain runs its
    float-input variant (reference dswx_hls.py:2298-2302 semantics).

    ``device_scale=True`` (requires float_inputs): bands arrive as RAW
    int16 plus two extra [B, 6] float32 inputs (per-band scale, offset,
    inserted after ``invalid``) and the cast runs on device, bit-identical
    to the host cast, while the host ships half the band bytes and does
    no full-tile float math.
    """
    if device_scale and not float_inputs:
        raise ValueError('device_scale requires float_inputs=True '
                         '(it feeds the float32 science chain)')
    n_extra = int(with_ocean) + int(with_shadow) + int(with_landcover)

    def per_tile(b, g, r, n, s1, s2, fm, inv, *extras):
        it = iter(extras)
        ocean = next(it) if with_ocean else None
        shadow = next(it) if with_shadow else None
        lc = next(it) if with_landcover else None
        return dswx_chain(b, g, r, n, s1, s2, fm, inv, config,
                          ocean_mask=ocean, shadow_layer=shadow,
                          landcover_mask=lc,
                          compute_browse=compute_browse)

    def local_step(b, g, r, n, s1, s2, fm, inv, *rest):
        if device_scale:
            scales, offsets, *extras = rest
            b, g, r, n, s1, s2 = _cast_scaled_bands(
                (b, g, r, n, s1, s2), scales, offsets)
        else:
            extras = rest
        out = jax.vmap(per_tile)(b, g, r, n, s1, s2, fm, inv, *extras)
        # int32 is safe per batch (<= local_tiles * 13.4M counts); the
        # runner re-accumulates across batches in Python integers
        totals = {
            'n_valid_total': jax.lax.psum(
                jnp.sum(out['n_valid'].astype(jnp.int32)), TILE_AXIS),
            'n_cloud_and_valid_total': jax.lax.psum(
                jnp.sum(out['n_cloud_and_valid'].astype(jnp.int32)),
                TILE_AXIS),
            'n_tiles_total': jax.lax.psum(
                jnp.asarray(b.shape[0], jnp.int32), TILE_AXIS),
        }
        return out, totals

    spec = P(TILE_AXIS)
    keys = ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF', 'CLOUD')
    if compute_browse:
        keys = keys + ('BROWSE',)
    layer_specs = {k: spec for k in
                   keys + ('n_valid', 'n_cloud_and_valid',
                           'n_not_ocean')}
    totals_specs = {'n_valid_total': P(), 'n_cloud_and_valid_total': P(),
                    'n_tiles_total': P()}

    n_in = 8 + (2 if device_scale else 0) + n_extra
    sharded = shard_map(local_step, mesh=mesh,
                        in_specs=(spec,) * n_in,
                        out_specs=(layer_specs, totals_specs),
                        check_vma=True)
    return jax.jit(sharded)


SPACE_AXIS = 'space'

# influence radius of the 'cover'-mode snow dilation chain: 10 iterations
# of snow dilation followed by 7 iterations of not-water dilation
SPATIAL_HALO = 17


def make_spatial_campaign_step(config: DswxChainConfig, mesh,
                               halo=SPATIAL_HALO, compute_browse=False,
                               with_ocean=False, with_shadow=False,
                               with_landcover=False,
                               float_inputs=False, device_scale=False):
    """Sharded step over a 2-D ('tile', 'space') mesh: tile batches are
    data-parallel on the tile axis AND each tile's rows are sharded over
    the space axis (the SP/CP analogue from SURVEY.md section 2).

    The only neighborhood ops in the chain are the 'cover'-mode snow
    dilations, whose total influence radius is 17 rows — each shard
    exchanges a 17-row halo with its neighbors (lax.ppermute), runs the
    identical fused chain on the padded block, and crops. Edge shards
    receive zero halos, which matches SciPy's border_value=0 dilation
    semantics, so results are bit-identical to single-device execution.

    ``float_inputs`` / ``device_scale`` mirror make_campaign_step: the
    scaled-reflectance chain, optionally with the bit-identical
    on-device scale*(f32(band)-offset) cast. The [B, 6] scale/offset
    vectors are per-TILE, so they are sharded on the tile axis only
    (replicated across space shards); the cast is elementwise and runs
    before the halo exchange, so seam semantics are unchanged.
    """
    if device_scale and not float_inputs:
        raise ValueError('device_scale requires float_inputs=True '
                         '(it feeds the float32 science chain)')
    n_space = mesh.shape[SPACE_AXIS]

    def with_halo(x, edge_fill=0):
        top = jax.lax.ppermute(x[:, -halo:, :], SPACE_AXIS,
                               [(j, j + 1) for j in range(n_space - 1)])
        bot = jax.lax.ppermute(x[:, :halo, :], SPACE_AXIS,
                               [(j, j - 1) for j in range(1, n_space)])
        if edge_fill:
            # rows beyond the global image boundary: SciPy's dilation
            # treats outside-image as 0 for both the snow mask and the
            # not-masked mask. A zero fmask ghost would make
            # not_masked = (~snow) & (cloud == 0) True there and seed
            # spurious growth, so edge ghosts carry the cloud bit, which
            # zeroes both dilation inputs without enabling growth into
            # the ghost (adjacent bit stays 0).
            idx = jax.lax.axis_index(SPACE_AXIS)
            fill = jnp.asarray(edge_fill, x.dtype)
            top = jnp.where(idx == 0, fill, top)
            bot = jnp.where(idx == n_space - 1, fill, bot)
        return jnp.concatenate([top, x, bot], axis=1)

    n_extra = int(with_ocean) + int(with_shadow) + int(with_landcover)

    def per_tile(b, g, r, n, s1, s2, fm, inv, *extras):
        it = iter(extras)
        ocean = next(it) if with_ocean else None
        shadow = next(it) if with_shadow else None
        lc = next(it) if with_landcover else None
        return dswx_chain(b, g, r, n, s1, s2, fm, inv, config,
                          ocean_mask=ocean, shadow_layer=shadow,
                          landcover_mask=lc,
                          compute_browse=compute_browse,
                          compute_stats=False)

    def local_step(b, g, r, n, s1, s2, fm, inv, *rest):
        if device_scale:
            scales, offsets, *extras = rest
            b, g, r, n, s1, s2 = _cast_scaled_bands(
                (b, g, r, n, s1, s2), scales, offsets)
        else:
            extras = rest
        if halo > b.shape[1]:
            raise ValueError(
                f'spatial halo ({halo}) exceeds the per-shard tile height'
                f' ({b.shape[1]}); use fewer space shards')
        padded = [with_halo(a) for a in (b, g, r, n, s1, s2)]
        padded.append(with_halo(fm, edge_fill=2))
        inv_p = with_halo(inv.astype(jnp.uint8)).astype(bool)
        padded.append(inv_p)
        # ancillary masks feed the dilation mask through WTR-2, so they
        # are halo-exchanged too; edge ghosts use their nodata-neutral
        # values (land=1 / not-shadow=1 / landcover fill 255), though the
        # ghost rows only matter within the dilation halo that is cropped
        # at the true image boundary anyway
        it = iter(extras)
        if with_ocean:
            padded.append(with_halo(next(it), edge_fill=1))
        if with_shadow:
            padded.append(with_halo(next(it), edge_fill=1))
        if with_landcover:
            padded.append(with_halo(next(it), edge_fill=255))
        out = jax.vmap(per_tile)(*padded)
        out = {k: v[:, halo:-halo, :] for k, v in out.items()}

        prelim = masking.compute_preliminary_cloud_layer(
            fm, config.mask_adjacent_to_cloud_mode)
        valid = ~inv
        axes = (TILE_AXIS, SPACE_AXIS)
        totals = {
            'n_valid_total': jax.lax.psum(
                jnp.sum(valid.astype(jnp.int32)), axes),
            'n_cloud_and_valid_total': jax.lax.psum(
                jnp.sum(((prelim != 0) & valid).astype(jnp.int32)), axes),
            'n_tiles_total': jax.lax.psum(
                jnp.asarray(b.shape[0], jnp.int32), TILE_AXIS),
        }
        return out, totals

    spec = P(TILE_AXIS, SPACE_AXIS)
    layer_names = ['DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF',
                   'CLOUD']
    if compute_browse:
        layer_names.append('BROWSE')
    layer_specs = {k: spec for k in layer_names}
    totals_specs = {'n_valid_total': P(), 'n_cloud_and_valid_total': P(),
                    'n_tiles_total': P()}
    in_specs = (spec,) * 8
    if device_scale:
        # [B, 6] vectors: per-tile, replicated across space shards
        in_specs = in_specs + (P(TILE_AXIS), P(TILE_AXIS))
    in_specs = in_specs + (spec,) * n_extra
    sharded = shard_map(local_step, mesh=mesh,
                        in_specs=in_specs,
                        out_specs=(layer_specs, totals_specs),
                        check_vma=True)
    return jax.jit(sharded)


class CampaignManifest:
    """Per-tile status ledger with atomic updates (resume + retry)."""

    def __init__(self, path):
        self.path = path
        self.state = {}
        if path and os.path.isfile(path):
            with open(path) as fh:
                self.state = json.load(fh)

    def status(self, tile_id):
        return self.state.get(tile_id, {}).get('status')

    def mark(self, tile_id, status, **extra):
        entry = self.state.setdefault(tile_id, {})
        entry['status'] = status
        entry['updated'] = time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                         time.gmtime())
        entry.update(extra)
        self._flush()

    def _flush(self):
        if not self.path:
            return
        tmp = self.path + '.tmp'
        with open(tmp, 'w') as fh:
            json.dump(self.state, fh, indent=1)
        os.replace(tmp, self.path)


class _AncillaryCache:
    """Per-grid LRU cache of prepared ancillary products.

    A campaign's ancillary inputs (DEM, CGLS, WorldCover, shoreline) are
    static files, and every HLS revisit of an MGRS tile shares the same
    product grid — so the warped DEM, the LAND mask, and the ocean mask
    are IDENTICAL across the time series. Caching them per (file
    signature, grid) turns their warps into a once-per-grid cost. Terrain shadow still runs per
    tile (it depends on the granule's sun angles) but reuses the cached
    DEM warp.

    Thread-safe with single-flight semantics: concurrent readers of the
    same key wait for the first computation instead of duplicating it.
    Capacity is grids, not bytes (~85 MB of device HBM per grid);
    PROTEUS_ANC_CACHE=0 disables.
    """

    def __init__(self, max_entries=None):
        self._max = max_entries
        self._lock = threading.Lock()
        self._entries = {}
        self._order = []

    @property
    def max_entries(self):
        if self._max is not None:
            return self._max
        try:
            return int(os.environ.get('PROTEUS_ANC_CACHE', '4'))
        except ValueError:
            return 4

    def get(self, key, compute):
        if self.max_entries <= 0:
            return compute()
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = {'event': threading.Event(), 'value': None,
                       'error': None}
                self._entries[key] = ent
                self._order.append(key)
                while len(self._order) > self.max_entries:
                    old = self._order.pop(0)
                    if old != key:
                        self._entries.pop(old, None)
                owner = True
            else:
                owner = False
        if not owner:
            ent['event'].wait()
            if ent['error'] is not None:
                raise ent['error']
            return ent['value']
        try:
            ent['value'] = compute()
        except BaseException as e:
            ent['error'] = e
            with self._lock:
                self._entries.pop(key, None)
                if key in self._order:
                    self._order.remove(key)
            ent['event'].set()
            raise
        ent['event'].set()
        return ent['value']

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._order.clear()


ANCILLARY_CACHE = _AncillaryCache()

def _fsig(path):
    """File identity for cache keys: path + mtime + size."""
    st = os.stat(path)
    return (path, st.st_mtime_ns, st.st_size)


class TileJob:
    """One campaign work item: HLS band files (+ optional ancillaries)
    -> output layer files."""

    def __init__(self, tile_id, input_files, output_dir,
                 product_id='dswx_hls', product_version='0.1',
                 dem_file=None, landcover_file=None, worldcover_file=None,
                 shoreline_shapefile=None,
                 ocean_masking_shoreline_distance_km=1.0):
        self.tile_id = tile_id
        self.input_files = input_files
        self.output_dir = output_dir
        self.product_id = product_id
        self.product_version = product_version
        self.dem_file = dem_file
        self.landcover_file = landcover_file
        self.worldcover_file = worldcover_file
        self.shoreline_shapefile = shoreline_shapefile
        self.ocean_masking_shoreline_distance_km = \
            ocean_masking_shoreline_distance_km


_FAULT_LOCK = threading.Lock()
_FAULT_ATTEMPTS = {}


def _maybe_inject_fault(tile_id):
    """Test-only fault injection (SURVEY.md section 5: the reference has
    no fault-injection facility; campaigns need one to prove the
    retry/resume machinery on real runs).

    PROTEUS_FAULT_INJECT="tileA:2,tileB" makes the reader raise an
    IOError for tileA on its first 2 attempts and for tileB on its
    first attempt — a transient failure the retry path must absorb.
    """
    spec = os.environ.get('PROTEUS_FAULT_INJECT')
    if not spec:
        return
    for item in spec.split(','):
        parts = item.strip().split(':')
        if not parts or parts[0] != tile_id:
            continue
        n = int(parts[1]) if len(parts) > 1 else 1
        with _FAULT_LOCK:
            k = _FAULT_ATTEMPTS.get(tile_id, 0)
            _FAULT_ATTEMPTS[tile_id] = k + 1
        if k < n:
            raise IOError(
                f'injected fault for {tile_id} (attempt {k + 1}/{n})')


_PREP_POOL = None
_PREP_POOL_LOCK = threading.Lock()


def _prep_pool():
    """Shared pool for within-tile ancillary preps (lazy, bounded).

    The three per-tile ancillary groups — ocean rasterization, DEM warp
    + terrain shadow, landcover warps — are independent and each is
    dominated by device-dispatch waits, not CPU. Running them
    concurrently cuts a COLD tile's critical path from their sum to
    their max (warm tiles hit _AncillaryCache and never enter the
    pool's queue long enough to matter). PROTEUS_PREP_THREADS sizes
    the pool; 0 disables (serial preps, the pre-round-5 behavior)."""
    global _PREP_POOL
    n = int(os.environ.get('PROTEUS_PREP_THREADS', '8'))
    if n <= 0:
        return None
    with _PREP_POOL_LOCK:
        if _PREP_POOL is None:
            _PREP_POOL = ThreadPoolExecutor(
                n, thread_name_prefix='anc_prep')
        return _PREP_POOL


def _run_preps(preps):
    """Run prep closures, concurrently when there are 2+ and a pool.

    Each closure returns a dict of image_dict updates (disjoint keys).
    The first prep runs on the calling reader thread — it stays busy
    instead of sleeping on a future — while the rest overlap in the
    pool. Exceptions propagate exactly as the serial code's did (the
    first to fail raises; the campaign retry path handles it)."""
    pool = _prep_pool() if len(preps) > 1 else None
    if pool is None:
        return [fn() for fn in preps]
    futures = [pool.submit(fn) for fn in preps[1:]]
    results = [preps[0]()]
    results += [f.result() for f in futures]
    return results


def _read_tile(job, flag_debug=False, config=None, scaled=False,
               device_scale=False):
    """Decode one tile's bands + prepare its ancillary masks (runs in the
    reader pool, overlapping the device step of the previous batch).

    The ancillary groups run concurrently via _run_preps: on a cold
    grid (every _AncillaryCache key missing — the continental-campaign
    regime measured by tools/bench_cold_grid.py) the tile pays
    max(ocean, dem+shadow, landcover) instead of their sum. The
    reference pays the full serial bill per tile (its per-tile _warp
    calls at dswx_hls.py:5145,5196 run in one process, one after the
    other).

    ``scaled=True`` applies the per-band scale/offset at ingest
    (float32 reflectance, reference dswx_hls.py:2298-2302).
    ``device_scale=True`` keeps the bands RAW int16 and records the
    per-band scale/offset vectors instead — the sharded step applies the
    cast on device (half the h2d bytes, no host float pass)."""
    _maybe_inject_fault(job.tile_id)
    from proteus_jax.io import hls as hls_io
    image_dict = {}
    metadata = {}
    offset_dict, scale_dict = {}, {}
    with STAGE_TIMES.stage('read_ingest_decode'):
        ok = hls_io.load_hls_product_v2(job.input_files, image_dict,
                                        offset_dict, scale_dict,
                                        metadata,
                                        scaled and not device_scale,
                                        flag_debug=flag_debug)
    if not ok:
        raise IOError(f'could not read tile {job.tile_id}')
    if device_scale:
        bands = ('blue', 'green', 'red', 'nir', 'swir1', 'swir2')
        image_dict['band_scales'] = np.asarray(
            [scale_dict.get(bn, 1.0) for bn in bands], np.float32)
        image_dict['band_offsets'] = np.asarray(
            [offset_dict.get(bn, 0.0) for bn in bands], np.float32)
    image_dict['hls_metadata'] = metadata

    gt = image_dict['geotransform']
    proj = image_dict['projection']
    length = image_dict['length']
    width = image_dict['width']

    preps = []

    if job.shoreline_shapefile:
        def _prep_ocean():
            from proteus_jax.geo.polygon import create_ocean_mask
            with STAGE_TIMES.stage('read_ocean_mask'):
                okey = ('ocean', _fsig(job.shoreline_shapefile),
                        job.ocean_masking_shoreline_distance_km, gt, proj,
                        length, width)
                return {'ocean_mask': ANCILLARY_CACHE.get(
                    okey, lambda: create_ocean_mask(
                        job.shoreline_shapefile,
                        job.ocean_masking_shoreline_distance_km, '.', gt,
                        proj, length, width, as_device=True))}
        preps.append(_prep_ocean)

    if job.dem_file:
        def _prep_dem_shadow():
            from proteus_jax.geo.warp import warp_to_grid_device
            from proteus_jax.models.dswx.shadow import (
                compute_opera_shadow_layer_exact,
                compute_otsu_shadow_layer_exact)
            from proteus_jax.runtime.orchestrator import _mean_angle
            with STAGE_TIMES.stage('read_dem_shadow'):
                az = _mean_angle(
                    metadata.get('MEAN_SUN_AZIMUTH_ANGLE', '0'))
                zen = _mean_angle(
                    metadata.get('MEAN_SUN_ZENITH_ANGLE', '0'))
                min_slope = (config.min_slope_angle
                             if config is not None else -5.0)
                max_inc = (config.max_sun_local_inc_angle
                           if config is not None else 40.0)
                shadow_alg = (config.shadow_masking_algorithm
                              if config is not None and
                              config.shadow_masking_algorithm else
                              'sun_local_inc_angle')
                m = C.DEM_MARGIN_IN_PIXELS
                import jax.numpy as jnp
                dkey = ('dem_warp', _fsig(job.dem_file), gt, proj,
                        length, width, m)

                def _warp_dem():
                    dem_m = warp_to_grid_device(
                        job.dem_file, gt, proj, length, width,
                        resample_algorithm='cubic', margin_in_pixels=m)
                    return dem_m, dem_m[m:-m, m:-m]

                # keep shadow/DEM on device: they feed the device step
                # and the writer pool (which materializes them there,
                # overlapped with the next batch). The DEM warp is per-grid
                # (cached); the shadow depends on the granule's sun
                # angles, so its cache key includes them
                dem_m, dem_crop = ANCILLARY_CACHE.get(dkey, _warp_dem)

                def _shadow():
                    if shadow_alg == 'otsu':
                        # reference dswx_hls.py:4430-4436: hillshade
                        # over the margined DEM + global-histogram
                        # Otsu cut
                        shad = compute_otsu_shadow_layer_exact(
                            dem_m, az, 90.0 - zen,
                            pixel_spacing_x=gt[1],
                            pixel_spacing_y=gt[5], as_device=True)
                    else:
                        shad = compute_opera_shadow_layer_exact(
                            dem_m, az, 90.0 - zen, min_slope, max_inc,
                            as_device=True)
                    shad_crop = jnp.asarray(shad[m:-m, m:-m], jnp.uint8)
                    # the writer only needs the binary SHAD values:
                    # copy 1 bit/px (1.7 MB instead of 13.4) to host
                    return shad_crop, pack_bits_device(shad_crop)

                skey = ('shadow', dkey, az, zen, min_slope, max_inc,
                        shadow_alg)
                shad_crop, shad_packed = ANCILLARY_CACHE.get(skey,
                                                             _shadow)
                # dkey identifies the warped-DEM payload exactly (file
                # signature + grid): the writer reuses the encoded COG
                # blobs across revisits of the grid (io/cog.py
                # PAYLOAD_CACHE — only the metadata tags differ)
                return {'dem': dem_crop, 'dem_payload_key': dkey,
                        'shadow_layer': shad_crop,
                        'shadow_packed': shad_packed}
        preps.append(_prep_dem_shadow)

    if job.landcover_file and job.worldcover_file:
        def _prep_landcover():
            from proteus_jax.geo.warp import (warp_to_grid_device,
                                              worldcover_year_of)
            from proteus_jax.models.dswx.landcover import \
                create_landcover_mask_arrays
            with STAGE_TIMES.stage('read_landcover'):
                forest = tuple(config.forest_mask_landcover_classes
                               if config is not None else
                               (20, 50, 111, 113, 115, 116, 121, 123,
                                125, 126))

                def _landcover():
                    cgls = warp_to_grid_device(
                        job.landcover_file, gt, proj, length, width,
                        resample_algorithm='nearest')
                    gt3 = (gt[0], gt[1] / 3, 0.0, gt[3], 0.0, gt[5] / 3)
                    wc3 = warp_to_grid_device(
                        job.worldcover_file, gt3, proj, 3 * length,
                        3 * width, resample_algorithm='nearest')
                    year = worldcover_year_of(job.worldcover_file)
                    import jax.numpy as jnp
                    return jnp.asarray(
                        create_landcover_mask_arrays(
                            cgls, wc3, C.LANDCOVER_MASK_TYPE, forest,
                            worldcover_year=year), jnp.uint8)

                lkey = ('landcover', _fsig(job.landcover_file),
                        _fsig(job.worldcover_file), gt, proj, length,
                        width, C.LANDCOVER_MASK_TYPE, forest)
                return {'landcover_mask': ANCILLARY_CACHE.get(
                    lkey, _landcover)}
        preps.append(_prep_landcover)

    for updates in _run_preps(preps):
        image_dict.update(updates)
    return image_dict


def _write_tile(job, layers, image_dict, metadata):
    """Write all available layers (+ browse) for one tile.

    ``layers`` values may still be device arrays — materialized here, in
    the writer pool, so the device->host transfer overlaps the next
    batch's compute."""
    from proteus_jax.runtime import ctables
    from proteus_jax.runtime import product_writer as pw
    from proteus_jax.io.png import geotiff2png
    with STAGE_TIMES.stage('write_d2h_layers'):
        layers = {name: np.asarray(a) for name, a in layers.items()}
    geotransform = image_dict['geotransform']
    projection = image_dict['projection']
    os.makedirs(job.output_dir, exist_ok=True)
    saved = []

    def path_for(nn, layer):
        return os.path.join(
            job.output_dir,
            f'{job.product_id}_v{job.product_version}_B{nn:02}'
            f'_{layer}.tif')

    order = [('WTR', 1), ('BWTR', 2), ('CONF', 3), ('DIAG', 4),
             ('WTR-1', 5), ('WTR-2', 6), ('CLOUD', 9)]
    with STAGE_TIMES.stage('write_cog_science'):
        for layer, nn in order:
            path = path_for(nn, layer)
            if layer in ('WTR', 'WTR-1', 'WTR-2'):
                pw.save_dswx_product(layers[layer], layer, path,
                                     metadata, geotransform, projection)
            elif layer == 'CLOUD':
                pw.save_cloud_layer(layers[layer], path, metadata,
                                    geotransform, projection,
                                    description=C.BAND_DESCRIPTION_DICT[
                                        'CLOUD'])
            elif layer == 'BWTR':
                pw.save_binary_water(layers[layer], path, metadata,
                                     geotransform, projection,
                                     description=C.BAND_DESCRIPTION_DICT[
                                         'BWTR'])
            elif layer == 'CONF':
                pw.save_array(layers[layer], path, metadata,
                              geotransform, projection,
                              description=C.BAND_DESCRIPTION_DICT[
                                  'CONF'],
                              ctable=
                              ctables.get_confidence_layer_ctable(),
                              no_data_value=C.UINT8_FILL_VALUE)
            else:
                pw.save_array(layers[layer], path, metadata,
                              geotransform, projection,
                              description=C.BAND_DESCRIPTION_DICT[
                                  'DIAG'],
                              no_data_value=
                              C.DIAGNOSTIC_LAYER_NO_DATA_BINARY_REPR)
            saved.append(path)

    if 'landcover_mask' in image_dict:
        path = path_for(7, 'LAND')
        with STAGE_TIMES.stage('write_cog_land'):
            pw.save_array(image_dict['landcover_mask'], path, metadata,
                          geotransform, projection,
                          description=C.BAND_DESCRIPTION_DICT['LAND'],
                          ctable=ctables.get_landcover_mask_ctable(),
                          no_data_value=C.UINT8_FILL_VALUE)
        saved.append(path)
    if 'shadow_layer' in image_dict:
        path = path_for(8, 'SHAD')
        with STAGE_TIMES.stage('write_cog_shad'):
            if 'shadow_packed' in image_dict:
                shad = unpack_bits(image_dict['shadow_packed'],
                                   image_dict['width'])
            else:
                shad = image_dict['shadow_layer']
            pw.save_array(shad, path, metadata,
                          geotransform, projection,
                          description=C.BAND_DESCRIPTION_DICT['SHAD'],
                          ctable=ctables.get_binary_mask_ctable())
        saved.append(path)
    if 'dem' in image_dict:
        path = path_for(10, 'DEM')
        with STAGE_TIMES.stage('write_d2h_dem'):
            dem_host = np.asarray(image_dict['dem'])
        with STAGE_TIMES.stage('write_cog_dem_float32'):
            pw.save_array(dem_host, path, metadata,
                          geotransform, projection,
                          description=C.BAND_DESCRIPTION_DICT['DEM'],
                          no_data_value=float('nan'),
                          payload_key=image_dict.get('dem_payload_key'))
        saved.append(path)

    if 'BROWSE' in layers:
        browse_tif = os.path.join(
            job.output_dir,
            f'{job.product_id}_v{job.product_version}_BROWSE.tif')
        browse_png = browse_tif.replace('.tif', '.png')
        ct = ctables.get_browse_ctable()
        with STAGE_TIMES.stage('write_browse'):
            pw.save_array(layers['BROWSE'], browse_tif, metadata,
                          geotransform, projection, ctable=ct,
                          no_data_value=C.UINT8_FILL_VALUE)
            geotiff2png(browse_tif, browse_png, output_height=1024,
                        output_width=1024, rgba_ctable=ct)
        saved += [browse_tif, browse_png]
    return saved


class CampaignRunner:
    """Drive a tile campaign: prefetch -> sharded device step -> write.

    The reader pool decodes batch k+1 while the device processes batch k;
    the writer pool overlaps COG encoding with both. Tiles that fail I/O
    or validation are retried up to ``max_retries`` and recorded in the
    manifest, so a crashed campaign resumes where it stopped.
    """

    def __init__(self, config: DswxChainConfig = None, mesh=None,
                 manifest_path=None, max_retries=2, reader_threads=None,
                 writer_threads=None, flag_debug=False,
                 save_browse=False, processing_params=None,
                 spatial_shards=1, tiles_per_device=1,
                 scaled_inputs=False, device_scale=True):
        # pool sizing: enough threads to overlap device/link waits with
        # host work, but not so many that they thrash a small host (8+8
        # threads on one core time-slice the NumPy/codec work and
        # inflate every stage)
        ncpu = os.cpu_count() or 1
        if reader_threads is None:
            reader_threads = max(2, min(8, ncpu))
        if writer_threads is None:
            writer_threads = max(2, min(8, ncpu))
        self.config = config or DswxChainConfig()
        self.scaled_inputs = bool(scaled_inputs)
        # scaled campaigns cast scale/offset on device (bit-identical to
        # the host cast, half the band bytes); device_scale=False keeps
        # the host cast
        self.device_scale = bool(device_scale) and self.scaled_inputs
        self.tiles_per_device = max(1, int(tiles_per_device or 1))
        self.spatial_shards = max(1, int(spatial_shards))
        if mesh is not None:
            self.mesh = mesh
        elif self.spatial_shards > 1:
            import jax as _jax
            from proteus_jax.parallel.mesh import make_tile_space_mesh
            n_dev = len(_jax.devices())
            if n_dev % self.spatial_shards:
                raise ValueError(
                    f'{n_dev} devices not divisible by spatial_shards='
                    f'{self.spatial_shards}')
            self.mesh = make_tile_space_mesh(
                n_dev // self.spatial_shards, self.spatial_shards)
        else:
            self.mesh = make_tile_mesh()
        self.manifest = CampaignManifest(manifest_path)
        self.max_retries = max_retries
        self.flag_debug = flag_debug
        self.save_browse = save_browse
        self.processing_params = processing_params or {}
        self._steps = {}  # keyed by (ocean, shadow, landcover) presence
        self._readers = ThreadPoolExecutor(reader_threads)
        self._writers = ThreadPoolExecutor(writer_threads)
        # tiles_per_device > 1 puts several tiles into one dispatch; each
        # device's local step vmaps over its tiles_per_device tiles
        self.batch_size = int(self.mesh.shape[TILE_AXIS]) \
            * self.tiles_per_device

    def _step_for(self, with_ocean, with_shadow, with_landcover):
        key = (with_ocean, with_shadow, with_landcover)
        if key not in self._steps:
            if self.spatial_shards > 1:
                self._steps[key] = make_spatial_campaign_step(
                    self.config, self.mesh,
                    compute_browse=self.save_browse,
                    with_ocean=with_ocean, with_shadow=with_shadow,
                    with_landcover=with_landcover,
                    float_inputs=self.scaled_inputs,
                    device_scale=self.device_scale)
            else:
                self._steps[key] = make_campaign_step(
                    self.config, self.mesh,
                    compute_browse=self.save_browse,
                    with_ocean=with_ocean, with_shadow=with_shadow,
                    with_landcover=with_landcover,
                    float_inputs=self.scaled_inputs,
                    device_scale=self.device_scale)
        return self._steps[key]

    def _tile_metadata(self, job, image_dict):
        """Per-tile product metadata from the tile's HLS attributes."""
        from proteus_jax.runtime import metadata as md_util
        md = md_util.get_dswx_metadata_dict(job.product_id,
                                            job.product_version)
        md.update(image_dict.get('hls_metadata', {}))
        md_util.populate_dswx_metadata_datasets(
            md, image_dict.get('hls_dataset_name', job.tile_id),
            dem_file=job.dem_file, landcover_file=job.landcover_file,
            worldcover_file=job.worldcover_file,
            shoreline_shapefile=job.shoreline_shapefile)
        return md

    def run(self, jobs, metadata=None):
        """Process all jobs; returns campaign statistics."""
        pending = [j for j in jobs
                   if self.manifest.status(j.tile_id) != 'done']
        logger.info(f'campaign: {len(jobs)} tiles, {len(pending)} pending,'
                    f' batch={self.batch_size} over'
                    f' {len(self.mesh.devices.flat)} devices')
        stats = {'tiles_done': 0, 'tiles_failed': 0,
                 'n_valid_total': 0, 'n_cloud_and_valid_total': 0}
        attempt = {j.tile_id: 0 for j in pending}
        queue = list(pending)
        write_futures = []

        def batches(seq, n):
            for i in range(0, len(seq), n):
                yield seq[i:i + n]

        batch_list = list(batches(queue, self.batch_size))

        def submit(batch):
            return [(j, self._readers.submit(_read_tile, j,
                                             self.flag_debug,
                                             self.config,
                                             self.scaled_inputs,
                                             self.device_scale))
                    for j in batch]

        marked = set()

        def drain_writes(block):
            """Mark finished writes in the manifest NOW (not at campaign
            end) so a killed campaign resumes from every tile whose
            outputs actually landed — the soak harness
            (tools/campaign_soak.py) kills mid-run and depends on it."""
            for job, fut in write_futures:
                if job.tile_id in marked:
                    continue
                if not block and not fut.done():
                    continue
                marked.add(job.tile_id)
                try:
                    saved = fut.result()
                    self.manifest.mark(job.tile_id, 'done',
                                       outputs=saved)
                    stats['tiles_done'] += 1
                except Exception as e:  # noqa: BLE001
                    logger.error(f'tile {job.tile_id} write failed: {e}')
                    self.manifest.mark(job.tile_id, 'failed',
                                       error=str(e))
                    stats['tiles_failed'] += 1

        # prefetch the first batch; retries may append batches mid-flight
        prefetch = submit(batch_list[0]) if batch_list else None
        bi = 0
        while bi < len(batch_list):
            # prefetch is None when a retry appended a batch after the
            # last scheduled one — submit it now
            current = prefetch if prefetch is not None \
                else submit(batch_list[bi])
            bi += 1
            prefetch = submit(batch_list[bi]) if bi < len(batch_list) \
                else None

            loaded = []
            for job, fut in current:
                try:
                    loaded.append((job, fut.result()))
                except Exception as e:  # noqa: BLE001
                    attempt[job.tile_id] += 1
                    if attempt[job.tile_id] <= self.max_retries:
                        logger.warning(f'tile {job.tile_id} read failed'
                                       f' (attempt {attempt[job.tile_id]}):'
                                       f' {e}; requeueing')
                        batch_list.append([job])
                    else:
                        logger.error(f'tile {job.tile_id} failed: {e}')
                        self.manifest.mark(job.tile_id, 'failed',
                                           error=str(e),
                                           trace=traceback.format_exc())
                        stats['tiles_failed'] += 1
            if not loaded:
                continue

            out, totals = self._run_batch(loaded)
            stats['n_valid_total'] += int(totals['n_valid_total'])
            stats['n_cloud_and_valid_total'] += int(
                totals['n_cloud_and_valid_total'])

            layer_names = [name for name in out
                           if name not in ('n_valid', 'n_cloud_and_valid',
                                           'n_not_ocean')]
            for k, (job, image_dict) in enumerate(loaded):
                # hand the writer the DEVICE slices: the np.asarray
                # materialization (device->host copy) happens in the
                # writer pool, overlapping the next batch's compute
                layers = {name: out[name][k] for name in layer_names}
                md = self._tile_metadata(job, image_dict)
                md.update(metadata or {})
                write_futures.append(
                    (job, self._writers.submit(
                        _write_tile, job, layers, image_dict, md)))
            drain_writes(block=False)

        drain_writes(block=True)
        if STAGE_TIMES.enabled:
            stats['stage_seconds'] = STAGE_TIMES.table()
        return stats

    def _run_batch(self, loaded):
        """Pad the batch to the device count, stage sharded, execute."""
        b = self.batch_size
        h = loaded[0][1]['length']
        w = loaded[0][1]['width']

        def stack(key, dtype, pad_value=0):
            arrs = [d[key] for _, d in loaded]
            if any(isinstance(a, jax.Array) for a in arrs):
                # device-resident inputs (shadow/dem/landcover): stack on
                # device — no host round-trip
                arrs = [jnp.asarray(a, dtype=dtype) for a in arrs]
                while len(arrs) < b:
                    arrs.append(jnp.full((h, w), pad_value, dtype=dtype))
                return jnp.stack(arrs)
            arrs = [np.asarray(a, dtype=dtype) for a in arrs]
            while len(arrs) < b:
                arrs.append(np.full((h, w), pad_value, dtype=dtype))
            return np.stack(arrs)

        if self.spatial_shards > 1:
            sharding = NamedSharding(self.mesh, P(TILE_AXIS, SPACE_AXIS))
        else:
            sharding = NamedSharding(self.mesh, P(TILE_AXIS))
        args = []
        band_dtype = np.float32 \
            if (self.scaled_inputs and not self.device_scale) else np.int16
        for key in ('blue', 'green', 'red', 'nir', 'swir1', 'swir2'):
            args.append(jax.device_put(stack(key, band_dtype),
                                       sharding))
        args.append(jax.device_put(stack('fmask', np.uint8), sharding))
        # pad tiles are fully invalid so they contribute nothing to the
        # campaign statistics
        args.append(jax.device_put(
            stack('invalid_ind_array', bool, pad_value=True), sharding))
        if self.device_scale:
            # [B, 6] per-band scale/offset vectors; pad tiles get the
            # identity cast (they are fully invalid anyway). Sharded on
            # the tile axis only (replicated across space shards)
            vec_sharding = NamedSharding(self.mesh, P(TILE_AXIS))

            def stack_vec(key, pad_value):
                vecs = [np.asarray(d[key], np.float32)
                        for _, d in loaded]
                while len(vecs) < b:
                    vecs.append(np.full(6, pad_value, np.float32))
                return np.stack(vecs)

            args.append(jax.device_put(stack_vec('band_scales', 1.0),
                                       vec_sharding))
            args.append(jax.device_put(stack_vec('band_offsets', 0.0),
                                       vec_sharding))
        d0 = loaded[0][1]
        with_ocean = 'ocean_mask' in d0
        with_shadow = 'shadow_layer' in d0
        with_landcover = 'landcover_mask' in d0
        if with_ocean:
            args.append(jax.device_put(
                stack('ocean_mask', np.uint8, pad_value=1), sharding))
        if with_shadow:
            args.append(jax.device_put(
                stack('shadow_layer', np.uint8, pad_value=1), sharding))
        if with_landcover:
            args.append(jax.device_put(
                stack('landcover_mask', np.uint8, pad_value=255),
                sharding))
        step = self._step_for(with_ocean, with_shadow, with_landcover)
        with STAGE_TIMES.stage('batch_device_step_dispatch'):
            out, totals = step(*args)
            # out stays on device: the writer pool materializes per-tile
            # slices, overlapping the transfers with the next batch's
            # compute
            totals = jax.device_get(totals)
        return out, totals
