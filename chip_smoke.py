"""Prove that the DSWx-HLS product path runs on the GPU and is right there.

Drives the product entry points in this process (a second JAX process
would compete for the card's memory) on synthetic inputs at the product
size, 3660 x 3660 pixels per tile, made by the committed generators in
``tests/synthetic.py`` (no download), and checks every output against the
repository's host references (``tests/oracle.py`` and the host float64
paths). Phases, one JSON line each:

  device    JAX version, device kind and count, XLA_FLAGS, the card's
            name and power limit, whether the native codec loaded
  pge       one ``dswx_hls`` run: every ancillary, the default
            sun_local_inc_angle shadow, the browse PNG
  campaign  ``dswx_campaign`` over 4 tiles (2 S30, 2 L30) on one grid at
            --tiles-per-device 1 and 4
  scaled    ``dswx_campaign --scaled`` over 2 tiles: device scale cast and
            host cast, against the float32-semantics oracle
  variants  one tile with the otsu shadow and 'cover' cloud-adjacent mode
  exact     core/f32exact boundary quotients and the double-double f32
            hillshade against host IEEE/float64, plus FMA and subnormal
            probes

With ``--four`` (four cards) it runs only the multi-card campaign steps,
data-parallel and data x spatial 'cover', against the same steps on one
card. Any failed check raises, so the script exits non-zero; it exits
non-zero, printing no result, when JAX finds no GPU. The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

    python chip_smoke.py            # one card
    python chip_smoke.py --four     # four cards
"""

import argparse
import functools
import glob
import json
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, 'tests'))

PHASES = ('device', 'pge', 'campaign', 'scaled', 'variants', 'exact')
FOUR_PHASES = ('four',)

# the float64 oracle's aerosol-remap lists: the runconfig defaults
AEROSOL_LISTS = {0: [224, 160, 96], 2: [224, 160, 96],
                 3: [224, 192, 160, 128, 96],
                 4: [224, 192, 160, 128, 96]}
SCIENCE_FILES = {'WTR': 'B01_WTR', 'BWTR': 'B02_BWTR', 'CONF': 'B03_CONF',
                 'DIAG': 'B04_DIAG', 'WTR-1': 'B05_WTR-1',
                 'WTR-2': 'B06_WTR-2', 'CLOUD': 'B09_CLOUD'}
COLLAPSED = ('WTR', 'WTR-1', 'WTR-2')
# device DEM warp vs host warp_to_grid: the CPU test of the same
# comparison (tests/test_geo.py test_device_cubic_nodata_matches_host)
# requires bit equality, NaN counted equal to NaN
DEM_TOLERANCE = 'exact: 0 differing values, NaN equals NaN'


class PhaseFailed(AssertionError):
    pass


def require(ok, message):
    if not ok:
        raise PhaseFailed(message)


def mismatches(got, want):
    """Number of differing elements (NaN equals NaN); shapes must agree."""
    got = np.asarray(got)
    want = np.asarray(want)
    require(got.shape == want.shape,
            f'shape {got.shape} differs from {want.shape}')
    diff = got != want
    if got.dtype.kind == 'f' and want.dtype.kind == 'f':
        diff &= ~(np.isnan(got) & np.isnan(want))
    return int(diff.sum())


def say(line):
    """Write one line to the process's real stdout: the product entry
    points redirect ``sys.stdout`` into their logger."""
    print(line, file=sys.__stdout__, flush=True)


def emit(phase, record):
    say(json.dumps({'phase': phase, **record}))


def final_line(devices):
    from proteus_jax.utils.gpu import device_record
    return json.dumps({'ok': True, 'device': device_record(devices)})


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description='Run the DSWx-HLS product path on the GPU and check '
                    'it against the host references')
    ap.add_argument('--four', action='store_true',
                    help='run only the four-card campaign steps and their '
                         'one-card comparison')
    ap.add_argument('--size', type=int, default=3660,
                    help='tile edge in pixels (the product size is 3660)')
    ap.add_argument('--workdir', default=os.path.join(HERE, '.chip_smoke'),
                    help='scratch directory for inputs and products '
                         '(emptied at start and end)')
    return ap.parse_args(argv)


def selected_phases(args):
    return FOUR_PHASES if args.four else PHASES


def read_layer(path):
    from proteus_jax.io.tiff import TiffReader
    with TiffReader(path) as r:
        return r.read()


class Inputs:
    """Synthetic tiles on one MGRS-like grid plus the shared ancillaries,
    and the host references for that grid (each made once)."""

    def __init__(self, root, size):
        self.root = root
        self.size = size
        self._tiles = {}
        self._anc = None
        self._ref = {}

    def tile(self, name, seed, product='S30'):
        if name not in self._tiles:
            import synthetic
            d = os.path.join(self.root, 'tiles', name)
            files, bands = synthetic.make_hls_v2_dataset(
                d, size=self.size, seed=seed, product=product)
            self._tiles[name] = (d, files, bands)
        return self._tiles[name]

    def ancillaries(self):
        if self._anc is None:
            import synthetic
            d = os.path.join(self.root, 'ancillary')
            os.makedirs(d, exist_ok=True)
            self._anc = dict(
                dem_file=synthetic.make_dem(d, size=self.size),
                landcover_file=synthetic.make_landcover(d, size=self.size),
                worldcover_file=synthetic.make_worldcover(d,
                                                          size=self.size),
                shoreline_shapefile=synthetic.make_shoreline(
                    d, size=self.size))
        return self._anc

    def grid(self):
        import synthetic
        return (synthetic.geotransform(), f'EPSG:{synthetic.EPSG}',
                self.size, self.size)

    def _cached(self, key, fn):
        if key not in self._ref:
            self._ref[key] = fn()
        return self._ref[key]

    def host_ocean(self, margin_km=1.0):
        from proteus_jax.geo.polygon import create_ocean_mask
        gt, proj, h, w = self.grid()
        return self._cached(('ocean', margin_km), lambda: create_ocean_mask(
            self.ancillaries()['shoreline_shapefile'], margin_km, None,
            gt, proj, h, w))

    def host_dem_margined(self):
        from proteus_jax.core import constants as C
        from proteus_jax.geo.warp import warp_to_grid
        gt, proj, h, w = self.grid()
        return self._cached('dem', lambda: warp_to_grid(
            self.ancillaries()['dem_file'], gt, proj, h, w,
            resample_algorithm='cubic',
            margin_in_pixels=C.DEM_MARGIN_IN_PIXELS))

    def sun(self):
        import synthetic
        from proteus_jax.runtime.orchestrator import _mean_angle
        az = _mean_angle(synthetic.HLS_METADATA['MEAN_SUN_AZIMUTH_ANGLE'])
        zen = _mean_angle(synthetic.HLS_METADATA['MEAN_SUN_ZENITH_ANGLE'])
        return az, 90 - float(zen)

    def host_shadow(self, algorithm='sun_local_inc_angle'):
        """SHAD from the host float64 paths on the host-warped DEM."""
        from proteus_jax.core import constants as C
        from proteus_jax.models.dswx import shadow as sh
        from proteus_jax.models.dswx.chain import DswxChainConfig

        def compute():
            m = C.DEM_MARGIN_IN_PIXELS
            dem_m = self.host_dem_margined()
            az, elev = self.sun()
            if algorithm == 'otsu':
                gt = self.grid()[0]
                hs = sh._host_hillshade_gdal(dem_m, az, elev, gt[1], gt[5])
                cut = sh._otsu_threshold_f64(
                    np.bincount(hs.ravel(), minlength=256))
                mask = hs > cut
            else:
                cfg = DswxChainConfig()
                mask = sh._host_shadow_exact(
                    dem_m, az, elev, cfg.min_slope_angle,
                    cfg.max_sun_local_inc_angle)
            return mask[m:-m, m:-m].astype(np.uint8)
        return self._cached(('shadow', algorithm), compute)

    def host_landcover(self):
        import oracle
        from proteus_jax.core import constants as C
        from proteus_jax.geo.warp import warp_to_grid, worldcover_year_of
        from proteus_jax.models.dswx.chain import DswxChainConfig

        def compute():
            anc = self.ancillaries()
            gt, proj, h, w = self.grid()
            cgls = warp_to_grid(anc['landcover_file'], gt, proj, h, w,
                                resample_algorithm='nearest')
            gt3 = (gt[0], gt[1] / 3, 0.0, gt[3], 0.0, gt[5] / 3)
            wc3 = warp_to_grid(anc['worldcover_file'], gt3, proj, 3 * h,
                               3 * w, resample_algorithm='nearest')
            return oracle.landcover_mask(
                cgls, wc3, C.LANDCOVER_MASK_TYPE,
                DswxChainConfig().forest_mask_landcover_classes,
                year=worldcover_year_of(anc['worldcover_file']))
        return self._cached('landcover', compute)


def oracle_layers(bands, mode='mask', ocean=None, shadow=None,
                  landcover=None, scaled=False):
    """The float64 oracle chain on a synthetic tile's raw bands, with the
    ingest semantics (negative clip, cumulative fill mask; with
    ``scaled`` the float32 ``scale * (band - offset)`` cast, so the chain
    runs in NumPy float32 as the reference's scaled mode does)."""
    import oracle
    from proteus_jax.core.thresholds import HlsThresholds
    t = HlsThresholds()
    tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
    names = (['B02', 'B03', 'B04', 'B8A', 'B11', 'B12'] if 'B8A' in bands
             else ['B02', 'B03', 'B04', 'B05', 'B06', 'B07'])  # L30
    invalid = np.zeros(bands[names[0]].shape, bool)
    arrs = []
    for name in names:
        invalid |= bands[name] == -9999
        a = np.clip(bands[name], 1, None)
        if scaled:
            a = np.float32(0.0001) * (a.astype(np.float32) - np.float32(0))
        arrs.append(a)
    return oracle.full_chain(*arrs, bands['Fmask'], invalid, tdict,
                             mode=mode, aerosol_lists=AEROSOL_LISTS,
                             ocean_mask=ocean, shadow=shadow,
                             landcover=landcover)


def compare_science(product_for, want):
    """{layer: mismatched pixels} of the 7 science layers against the
    oracle; ``product_for(tag)`` is the product path for 'B01_WTR' etc."""
    import oracle
    out = {}
    for layer, tag in SCIENCE_FILES.items():
        expected = want[layer]
        if layer in COLLAPSED:
            expected = oracle.collapse(expected)
        out[layer] = mismatches(read_layer(product_for(tag)), expected)
    return out


def raster_digest(directory):
    """{file: raster bytes} of every .tif (decoded: the tags carry the
    processing time) and every .png (whole file) under ``directory``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, '**', '*.tif'),
                                 recursive=True)):
        out[os.path.relpath(path, directory)] = read_layer(path).tobytes()
    for path in sorted(glob.glob(os.path.join(directory, '**', '*.png'),
                                 recursive=True)):
        with open(path, 'rb') as fh:
            out[os.path.relpath(path, directory)] = fh.read()
    return out


def differing_files(a, b):
    require(sorted(a) == sorted(b),
            f'product sets differ: {sorted(set(a) ^ set(b))}')
    return [k for k in a if a[k] != b[k]]


def card_line():
    from proteus_jax.utils.gpu import card_identity
    return card_identity()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(ctx):
    import jax
    from proteus_jax import native
    from proteus_jax.utils.gpu import parse_nvidia_smi
    devices = jax.devices()
    require(devices[0].platform == 'gpu',
            f'platform is {devices[0].platform!r}, not gpu')
    emit('device', {'jax': jax.__version__,
                    'device_kind': devices[0].device_kind,
                    'count': len(devices),
                    'XLA_FLAGS': os.environ.get('XLA_FLAGS', ''),
                    'cards': parse_nvidia_smi(card_line()),
                    'native_codec': native.available()})


def _runconfig(ctx, name, input_dir, extra=None):
    import synthetic
    root = os.path.join(ctx['inputs'].root, name)
    os.makedirs(root)
    out = os.path.join(root, 'output')
    rc = synthetic.write_runconfig(
        os.path.join(root, 'rc.yaml'), input_dir, out,
        os.path.join(root, 'scratch'), check_coverage=True,
        apply_ocean_masking=True, extra_processing=extra,
        **ctx['inputs'].ancillaries())
    return rc, out


def _pge_product(out, tag):
    return os.path.join(out, f'dswx_hls_test_v0.1_{tag}.tif')


def _run_pge(rc):
    """dswx_hls on one runconfig; returns (seconds, StageTimers table)."""
    from proteus_jax.cli import dswx_hls
    from proteus_jax.runtime import orchestrator
    seen = []

    class RecordedTimers(orchestrator.StageTimers):
        def __init__(self):
            super().__init__()
            seen.append(self)

    orig = orchestrator.StageTimers
    orchestrator.StageTimers = RecordedTimers
    try:
        t0 = time.perf_counter()
        dswx_hls.main([rc])
        seconds = time.perf_counter() - t0
    finally:
        orchestrator.StageTimers = orig
    stages = {name: s for t in seen for name, s in t.stages}
    return seconds, stages


def phase_pge(ctx):
    from proteus_jax.core import constants as C
    from proteus_jax.io.validate_cog import validate_cog
    inputs = ctx['inputs']
    tile_dir, _files, bands = inputs.tile('T0', 11)
    rc, out = _runconfig(ctx, 'pge', tile_dir)
    seconds, stages = _run_pge(rc)
    product = functools.partial(_pge_product, out)

    ref_t0 = time.perf_counter()
    want = oracle_layers(bands, ocean=inputs.host_ocean(),
                         shadow=inputs.host_shadow(),
                         landcover=inputs.host_landcover())
    m = C.DEM_MARGIN_IN_PIXELS
    dem_want = inputs.host_dem_margined()[m:-m, m:-m]
    ref_seconds = time.perf_counter() - ref_t0

    science = compare_science(product, want)
    extra = {'SHAD': mismatches(read_layer(product('B08_SHAD')),
                                inputs.host_shadow()),
             'LAND': mismatches(read_layer(product('B07_LAND')),
                                inputs.host_landcover()),
             'DEM': mismatches(read_layer(product('B10_DEM')), dem_want)}
    tifs = sorted(glob.glob(os.path.join(out, '*.tif')))
    cog_errors = {os.path.basename(p): validate_cog(p) for p in tifs}
    cog_errors = {k: v for k, v in cog_errors.items() if v}
    png = os.path.join(out, 'dswx_hls_test_v0.1_BROWSE.png')
    emit('pge', {'size': inputs.size, 'wall_seconds_from_entry': seconds,
                 'stage_seconds': stages,
                 'host_reference_seconds': ref_seconds,
                 'mismatched_pixels': {**science, **extra},
                 'dem_tolerance': DEM_TOLERANCE,
                 'cogs_validated': len(tifs), 'cog_errors': cog_errors,
                 'browse_png_bytes': os.path.getsize(png),
                 'card': card_line()})
    require(len(tifs) == 11, f'{len(tifs)} GeoTIFFs, expected 11')
    require(not cog_errors, f'invalid COGs: {cog_errors}')
    require(not any(science.values()) and not any(extra.values()),
            f'pge products differ from the host references: '
            f'{science} {extra}')


def _campaign(ctx, tag, tile_dirs, *extra_args):
    """dswx_campaign with every ancillary; returns (out_dir, seconds,
    stats)."""
    from proteus_jax.cli import dswx_campaign
    from proteus_jax.io import cog
    from proteus_jax.parallel import campaign
    anc = ctx['inputs'].ancillaries()
    out = os.path.join(ctx['inputs'].root, tag)
    stats_path = os.path.join(ctx['inputs'].root, f'{tag}.stats.json')
    # every run starts from a cold grid: no ancillary or COG payload
    # carried over from an earlier run in this process
    campaign.ANCILLARY_CACHE.clear()
    cog.PAYLOAD_CACHE.clear()
    campaign.STAGE_TIMES.reset()
    t0 = time.perf_counter()
    dswx_campaign.main(list(tile_dirs) + [
        '-o', out, '--dem', anc['dem_file'],
        '--landcover', anc['landcover_file'],
        '--worldcover', anc['worldcover_file'],
        '--shoreline', anc['shoreline_shapefile'], '--browse',
        '--stats-json', stats_path, *extra_args])
    seconds = time.perf_counter() - t0
    with open(stats_path) as fh:
        stats = json.load(fh)
    require(stats['tiles_failed'] == 0, f'{tag}: {stats}')
    return out, seconds, stats


def _tile_product(out, tile_id, tag):
    return os.path.join(out, tile_id, f'{tile_id}_v1.0_{tag}.tif')


def phase_campaign(ctx):
    inputs = ctx['inputs']
    tiles = [('T0', 11, 'S30'), ('T1', 12, 'S30'), ('T2', 13, 'L30'),
             ('T3', 14, 'L30')]
    dirs = [inputs.tile(*t)[0] for t in tiles]
    runs = {}
    for b in (1, 4):
        out, seconds, stats = _campaign(ctx, f'campaign_b{b}', dirs,
                                        '--tiles-per-device', str(b))
        runs[b] = {'out': out, 'tiles_per_min': 60.0 * len(dirs) / seconds,
                   'seconds': seconds,
                   'stage_seconds': stats.get('stage_seconds', {})}
    differing = differing_files(raster_digest(runs[1]['out']),
                                raster_digest(runs[4]['out']))
    want = oracle_layers(inputs.tile('T0', 11)[2],
                         ocean=inputs.host_ocean(),
                         shadow=inputs.host_shadow(),
                         landcover=inputs.host_landcover())
    tile0 = compare_science(
        lambda tag: _tile_product(runs[1]['out'], 'T0', tag), want)
    emit('campaign', {
        'tiles': len(dirs), 'size': inputs.size,
        'per_tiles_per_device': {
            str(b): {k: v for k, v in r.items() if k != 'out'}
            for b, r in runs.items()},
        'files_differing_b1_b4': differing,
        'tile0_mismatched_pixels': tile0, 'card': card_line()})
    require(not differing, f'B=1 and B=4 products differ: {differing}')
    require(not any(tile0.values()), f'tile 0 differs from the oracle: '
                                     f'{tile0}')


def phase_scaled(ctx):
    from proteus_jax.models.dswx.chain import DswxChainConfig
    from proteus_jax.parallel.campaign import CampaignRunner, TileJob
    inputs = ctx['inputs']
    tiles = [('T0', 11, 'S30'), ('T2', 13, 'L30')]
    dirs = [inputs.tile(*t)[0] for t in tiles]
    dev_out, dev_seconds, _ = _campaign(ctx, 'scaled_device', dirs,
                                        '--scaled')
    # the host cast is a runner argument, not a CLI option
    host_out = os.path.join(inputs.root, 'scaled_host')
    anc = inputs.ancillaries()
    jobs = [TileJob(os.path.basename(d),
                    sorted(glob.glob(os.path.join(d, '*.tif'))),
                    os.path.join(host_out, os.path.basename(d)),
                    product_id=os.path.basename(d), product_version='1.0',
                    **anc)
            for d in dirs]
    runner = CampaignRunner(config=DswxChainConfig(), save_browse=True,
                            scaled_inputs=True, device_scale=False)
    t0 = time.perf_counter()
    stats = runner.run(jobs)
    host_seconds = time.perf_counter() - t0
    require(stats['tiles_failed'] == 0, f'host-cast run: {stats}')
    differing = differing_files(raster_digest(dev_out),
                                raster_digest(host_out))
    oracle_mism = {}
    for name, seed, _ in tiles:
        want = oracle_layers(inputs.tile(name, seed)[2], scaled=True,
                             ocean=inputs.host_ocean(),
                             shadow=inputs.host_shadow(),
                             landcover=inputs.host_landcover())
        for tag, out in (('device_cast', dev_out), ('host_cast', host_out)):
            oracle_mism[f'{name}_{tag}'] = compare_science(
                lambda t, o=out, n=name: _tile_product(o, n, t), want)
    emit('scaled', {'tiles': len(dirs), 'size': inputs.size,
                    'device_cast_seconds': dev_seconds,
                    'host_cast_seconds': host_seconds,
                    'files_differing_device_host': differing,
                    'mismatched_pixels': oracle_mism, 'card': card_line()})
    require(not differing, f'device and host cast differ: {differing}')
    require(not any(v for r in oracle_mism.values() for v in r.values()),
            f'scaled products differ from the oracle: {oracle_mism}')


def phase_variants(ctx):
    inputs = ctx['inputs']
    tile_dir, _files, bands = inputs.tile('T0', 11)
    rc, out = _runconfig(ctx, 'variants', tile_dir,
                         extra={'shadow_masking_algorithm': 'otsu',
                                'mask_adjacent_to_cloud_mode': 'cover'})
    seconds, stages = _run_pge(rc)
    product = functools.partial(_pge_product, out)

    shadow = inputs.host_shadow('otsu')
    want = oracle_layers(bands, mode='cover', ocean=inputs.host_ocean(),
                         shadow=shadow, landcover=inputs.host_landcover())
    science = compare_science(product, want)
    science['SHAD'] = mismatches(read_layer(product('B08_SHAD')), shadow)
    emit('variants', {'shadow_masking_algorithm': 'otsu',
                      'mask_adjacent_to_cloud_mode': 'cover',
                      'size': inputs.size, 'wall_seconds_from_entry': seconds,
                      'stage_seconds': stages,
                      'mismatched_pixels': science, 'card': card_line()})
    require(not any(science.values()),
            f'otsu/cover products differ from the oracle: {science}')


# -- exact arithmetic ---------------------------------------------------------

RATIO_THRESHOLDS = (0.124, -0.44, 0.7, -0.5, 1 / 3, 0.1237)


def ratio_boundary_cases(n, seed=20260816):
    """Quotients at and 1-2 ULPs around each threshold's float32 rounding
    boundary: yields (t, op, num, den) with 5*n operand pairs."""
    rng = np.random.default_rng(seed)
    for t in RATIO_THRESHOLDS:
        for op in ('gt', 'lt'):
            den = rng.random(n).astype(np.float32) * 13.2 - 6.6
            den[den == 0] = np.float32(1e-4)
            t32 = np.float32(t)
            tn = np.nextafter(t32, np.float32(np.inf if op == 'gt'
                                              else -np.inf))
            m = (np.float64(t32) + np.float64(tn)) * 0.5
            base = (m * den.astype(np.float64)).astype(np.float32)
            nums = [base]
            up = down = base
            for _ in range(2):
                up = np.nextafter(up, np.float32(np.inf))
                down = np.nextafter(down, np.float32(-np.inf))
                nums += [up, down]
            yield t, op, np.concatenate(nums), np.tile(den, len(nums))


def exact_ratio_mismatches(n):
    """[{t, op, n, mismatches}] of core/f32exact.ratio_cmp on the device
    against host IEEE float32 division."""
    import jax
    from proteus_jax.core.f32exact import ratio_boundary, ratio_cmp
    out = []
    for t, op, num, den in ratio_boundary_cases(n):
        b = ratio_boundary(t, op, 'f32')
        got = np.asarray(jax.jit(lambda a, d, b=b: ratio_cmp(a, d, b))(
            num, den))
        with np.errstate(divide='ignore', invalid='ignore'):
            q = num / den
        want = (q > np.float32(t)) if op == 'gt' else (q < np.float32(t))
        out.append({'t': t, 'op': op, 'n': int(num.size),
                    'mismatches': mismatches(got, want)})
    return out


def exact_diag_mismatches(size, seed=7):
    """Scaled (float32) diagnostic tests with an adversarial stripe at
    the MNDWI boundary, and integer tests with non-decimal thresholds,
    against the oracle's NumPy evaluation."""
    import jax
    import oracle
    from proteus_jax.core.thresholds import HlsThresholds
    from proteus_jax.models.dswx.diagnostics import compute_diagnostic_tests
    rng = np.random.default_rng(seed)
    t = HlsThresholds()
    shape = (size, size)
    bands = [np.float32(0.0001) * np.clip(
        rng.integers(-2000, 18000, shape), 1, None).astype(np.float32)
        for _ in range(6)]
    t32 = np.float32(t.wigt)
    m = (np.float64(t32) + np.float64(np.nextafter(
        t32, np.float32(np.inf)))) * 0.5
    stripe = min(64, size)
    bands[1][:stripe] = (bands[4][:stripe].astype(np.float64)
                         * (1 + m) / (1 - m)).astype(np.float32)
    tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
    got = jax.jit(lambda *b: compute_diagnostic_tests(*b, t))(*bands)
    scaled = mismatches(got, oracle.diagnostic_tests(*bands, tdict))

    t_nd = HlsThresholds().replace(wigt=1 / 3, awgt=1 / 7,
                                   pswt_1_ndvi=-2 / 7,
                                   pswt_1_swir1=900.5 + 1e-11)
    ishape = (min(size, 1024),) * 2
    ibands = [rng.integers(-32768, 32767, ishape).astype(np.int16)
              for _ in range(6)]
    s1 = np.clip(np.abs(ibands[4]).astype(np.int64), 1, 32767)
    g0 = np.round(s1 * (1 + 1 / 3) / (1 - 1 / 3))
    ibands[1] = np.clip(g0 + rng.integers(-2, 3, ishape), -32768,
                        32767).astype(np.int16)
    ibands[4] = s1.astype(np.int16)
    td = {k: getattr(t_nd, k) for k in t_nd.__dataclass_fields__}
    got = jax.jit(lambda *b: compute_diagnostic_tests(*b, t_nd))(*ibands)
    nondecimal = mismatches(got, oracle.diagnostic_tests(*ibands, td))
    return {'scaled_f32': scaled, 'integer_nondecimal': nondecimal}


def hillshade_terrains(size, names):
    rng = np.random.default_rng(20260818)
    base = rng.normal(0, 1, (size, size)).cumsum(0).cumsum(1)
    smooth = (base / np.abs(base).max() * 800 + 200).astype(np.float32)
    out = {'smooth': smooth}
    if 'plateau_6000m' in names:
        # high altitude: the worst float32 cancellation
        out['plateau_6000m'] = (6000.0 + rng.normal(
            0, 2.0, (size, size))).astype(np.float32)
    if 'nan_holed' in names:
        holed = smooth.copy()
        holed[rng.random((size, size)) < 0.05] = np.nan
        out['nan_holed'] = holed
    return {k: out[k] for k in names}


HILLSHADE_CASES = (('smooth', 135.0, 45.0), ('plateau_6000m', 277.3, 18.0),
                   ('nan_holed', 80.0, 70.0))


def exact_hillshade_mismatches(size, cases=HILLSHADE_CASES):
    """Device dd-f32 hillshade bytes and otsu masks against the host
    float64 oracle, one sun geometry per terrain."""
    import jax.numpy as jnp
    from proteus_jax.models.dswx import shadow as sh
    dems = hillshade_terrains(size, [c[0] for c in cases])
    out = []
    for name, az, elev in cases:
        dem = dems[name]
        t0 = time.perf_counter()
        want = sh._host_hillshade_gdal(dem, az, elev, 30.0, -30.0)
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = np.asarray(sh.compute_hillshade_exact(jnp.asarray(dem), az,
                                                    elev, as_device=True))
        device_s = time.perf_counter() - t0
        cut = sh._otsu_threshold_f64(np.bincount(want.ravel(),
                                                 minlength=256))
        mask = np.asarray(sh.compute_otsu_shadow_layer_exact(
            jnp.asarray(dem), az, elev, as_device=True))
        out.append({'terrain': name, 'az': az, 'elev': elev,
                    'size': size,
                    'mismatched_bytes': mismatches(got, want),
                    'otsu_mask_mismatches': mismatches(mask, want > cut),
                    'device_seconds': device_s, 'host_seconds': host_s})
    return out


def arithmetic_probes():
    """What the compiled float32 arithmetic does on this device: does
    ``a*b + c`` contract into a fused multiply-add, are subnormal results
    and inputs flushed to zero, and how often does division differ from
    the correctly rounded quotient."""
    import jax
    one = np.float32(1 + 2.0 ** -12)
    # a*b = 1 + 2^-11 + 2^-24: rounded first it cancels c exactly; fused
    # it leaves 2^-24
    a = np.full(8, one, np.float32)
    c = np.full(8, -np.float32(1 + 2.0 ** -11), np.float32)
    fma = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, a, c))
    # runtime operands, so that the compiler cannot fold the probes
    tiny = np.full(8, np.finfo(np.float32).tiny, np.float32)
    halved = np.asarray(jax.jit(lambda x, y: x * y)(
        tiny, np.full(8, 0.5, np.float32)))
    sub_in = np.full(8, np.finfo(np.float32).tiny / 4, np.float32)
    passed = np.asarray(jax.jit(lambda x, y: x + y)(
        sub_in, np.zeros(8, np.float32)))
    rng = np.random.default_rng(5)
    num = rng.standard_normal(1 << 20).astype(np.float32)
    den = rng.standard_normal(1 << 20).astype(np.float32)
    quot = np.asarray(jax.jit(lambda x, y: x / y)(num, den))
    return {'fma_contracted': bool((fma != 0).any()),
            'subnormal_results_flushed': bool((halved == 0).all()),
            'subnormal_inputs_flushed': bool((passed == 0).all()),
            'division_not_correctly_rounded': int(
                (quot != num / den).sum()),
            'division_samples': int(num.size)}


def phase_exact(ctx, ratio_n=1 << 18, hillshade_cases=HILLSHADE_CASES):
    from proteus_jax.core import constants as C
    size = ctx['inputs'].size
    ratio = exact_ratio_mismatches(ratio_n)
    diag = exact_diag_mismatches(size)
    hill = exact_hillshade_mismatches(size + 2 * C.DEM_MARGIN_IN_PIXELS,
                                      hillshade_cases)
    probes = arithmetic_probes()
    emit('exact', {'ratio_cmp': ratio, 'diag': diag, 'hillshade': hill,
                   'probes': probes, 'card': card_line()})
    bad = (sum(r['mismatches'] for r in ratio) + sum(diag.values())
           + sum(h['mismatched_bytes'] + h['otsu_mask_mismatches']
                 for h in hill))
    require(bad == 0, f'{bad} exactness mismatches on the device')


# -- four cards ---------------------------------------------------------------

def _random_campaign_batch(rng, b, size):
    bands = [np.clip(rng.integers(-2000, 15000, (b, size, size)), 1,
                     None).astype(np.int16) for _ in range(6)]
    fmask = rng.integers(0, 256, (b, size, size)).astype(np.uint8)
    invalid = rng.random((b, size, size)) < 0.02
    ocean = (rng.random((b, size, size)) < 0.9).astype(np.uint8)
    shadow = (rng.random((b, size, size)) < 0.8).astype(np.uint8)
    land = rng.choice(np.array([0, 100, 200, 201, 255], np.uint8),
                      (b, size, size))
    return bands + [fmask, invalid, ocean, shadow, land]


def _compare_steps(got, want):
    out_g, tot_g = got
    out_w, tot_w = want
    require(sorted(out_g) == sorted(out_w), 'output layers differ')
    layers = {k: mismatches(out_g[k], out_w[k]) for k in sorted(out_g)}
    totals = {k: [int(tot_g[k]), int(tot_w[k])] for k in sorted(tot_g)}
    return layers, totals


def _shard_devices(out):
    return {k: sorted({int(s.device.id) for s in v.addressable_shards})
            for k, v in out.items()}


def phase_four(ctx, n_cards=4):
    import jax
    from proteus_jax.models.dswx.chain import DswxChainConfig
    from proteus_jax.parallel.campaign import (make_campaign_step,
                                               make_spatial_campaign_step)
    from proteus_jax.parallel.mesh import make_tile_mesh, make_tile_space_mesh
    devices = jax.devices()
    require(len(devices) >= n_cards,
            f'{len(devices)} devices, --four needs {n_cards}')
    devices = devices[:n_cards]
    size = ctx['inputs'].size
    rng = np.random.default_rng(4)
    anc = dict(with_ocean=True, with_shadow=True, with_landcover=True)
    record = {'size': size, 'cards': n_cards}

    batch = _random_campaign_batch(rng, 2 * n_cards, size)
    cfg = DswxChainConfig()
    t0 = time.perf_counter()
    dp = make_campaign_step(cfg, make_tile_mesh(devices), **anc)(*batch)
    jax.block_until_ready(dp)
    dp_seconds = time.perf_counter() - t0
    one = make_campaign_step(cfg, make_tile_mesh(devices[:1]), **anc)(*batch)
    layers, totals = _compare_steps(dp, one)
    record['dp'] = {'tiles': 2 * n_cards, 'mode': 'mask',
                    'seconds_incl_compile': dp_seconds,
                    'mismatched_pixels': layers, 'totals': totals,
                    'shard_devices': _shard_devices(dp[0])}

    n_tile, n_space = 2, n_cards // 2
    cover = DswxChainConfig(mask_adjacent_to_cloud_mode='cover')
    sp_batch = [a[:n_tile] for a in batch]
    t0 = time.perf_counter()
    sp = make_spatial_campaign_step(
        cover, make_tile_space_mesh(n_tile, n_space, devices),
        **anc)(*sp_batch)
    jax.block_until_ready(sp)
    sp_seconds = time.perf_counter() - t0
    sp_one = make_spatial_campaign_step(
        cover, make_tile_space_mesh(1, 1, devices[:1]), **anc)(*sp_batch)
    sp_layers, sp_totals = _compare_steps(sp, sp_one)
    record['dp_x_sp'] = {'tiles': n_tile, 'mesh': [n_tile, n_space],
                         'mode': 'cover',
                         'seconds_incl_compile': sp_seconds,
                         'mismatched_pixels': sp_layers,
                         'totals': sp_totals,
                         'shard_devices': _shard_devices(sp[0])}
    record['card'] = card_line()
    emit('four', record)
    for key in ('dp', 'dp_x_sp'):
        r = record[key]
        require(not any(r['mismatched_pixels'].values()),
                f'{key} differs from one card: {r["mismatched_pixels"]}')
        require(all(a == b for a, b in r['totals'].values()),
                f'{key} totals differ from one card: {r["totals"]}')
        spread = {d for ds in r['shard_devices'].values() for d in ds}
        require(len(spread) == n_cards,
                f'{key} outputs sit on devices {sorted(spread)}')


PHASE_FUNCS = {'device': phase_device, 'pge': phase_pge,
               'campaign': phase_campaign, 'scaled': phase_scaled,
               'variants': phase_variants, 'exact': phase_exact,
               'four': phase_four}


def run_phases(phases, size, workdir):
    """Run ``phases`` on synthetic inputs of edge ``size`` under
    ``workdir`` (created empty, removed afterwards)."""
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ctx = {'inputs': Inputs(workdir, size)}
    try:
        for phase in phases:
            t0 = time.perf_counter()
            PHASE_FUNCS[phase](ctx)
            say(f'# phase {phase}: {time.perf_counter() - t0:.1f} s')
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    args = parse_args(argv)
    # the campaign runner reads this when it is imported
    os.environ.setdefault('PROTEUS_STAGE_TIMES', '1')
    from proteus_jax.utils import compile_cache
    from proteus_jax.utils.gpu import NoGpuError, require_gpu
    try:
        devices = require_gpu()
    except NoGpuError as exc:
        print(f'chip_smoke.py: {exc}', file=sys.stderr)
        return 2
    compile_cache.enable()
    t0 = time.perf_counter()
    run_phases(selected_phases(args), args.size, args.workdir)
    say(f'# all phases: {time.perf_counter() - t0:.1f} s')
    if args.four:
        devices = devices[:4]
    say(card_line())
    say(final_line(devices))
    return 0


if __name__ == '__main__':
    sys.exit(main())
