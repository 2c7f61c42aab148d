"""Randomized bit-exactness fuzz: device chain vs float64 oracle.

Not collected by pytest (run manually):
    python tests/fuzz_chain.py [n_iterations]

Each iteration draws random band statistics (including int16-extreme and
near-threshold regimes), random fmask/invalid/ancillary masks, a random
adjacent-to-cloud mode, and random (exact-decimal) thresholds, then
asserts every product layer is bit-identical to the oracle.
"""

import sys
import os

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _here)
sys.path.insert(0, os.path.dirname(_here))  # repo root for proteus_jax

import numpy as np

import jax

jax.config.update('jax_platforms', 'cpu')

import oracle  # noqa: E402
from proteus_jax.core.thresholds import HlsThresholds  # noqa: E402
from proteus_jax.models.dswx.chain import (DswxChainConfig,  # noqa: E402
                                           dswx_chain)


def random_thresholds(rng):
    def dec(lo, hi, digits):
        return round(float(rng.uniform(lo, hi)), digits)
    return HlsThresholds(
        wigt=dec(-0.5, 0.5, 3), awgt=dec(-200, 200, 2),
        pswt_1_mndwi=dec(-0.9, 0.2, 3), pswt_1_nir=int(rng.integers(
            200, 4000)),
        pswt_1_swir1=int(rng.integers(200, 4000)),
        pswt_1_ndvi=dec(0.1, 0.9, 3),
        pswt_2_mndwi=dec(-0.9, 0.2, 3),
        pswt_2_blue=int(rng.integers(200, 4000)),
        pswt_2_nir=int(rng.integers(500, 6000)),
        pswt_2_swir1=int(rng.integers(500, 6000)),
        pswt_2_swir2=int(rng.integers(200, 4000)),
        lcmask_nir=int(rng.integers(400, 3000)))


def one_iteration(seed):
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(16, 160)), int(rng.integers(16, 160)))
    regime = rng.integers(0, 3)
    lo, hi = [(-2000, 18000), (-32768, 32767), (1, 400)][regime]
    bands = [rng.integers(lo, hi, shape).astype(np.int16)
             for _ in range(6)]
    bands = [np.clip(b, 1, None) for b in bands]
    fmask = rng.integers(0, 256, shape).astype(np.uint8)
    invalid = rng.random(shape) < rng.uniform(0, 0.2)
    ocean = (rng.random(shape) < 0.9).astype(np.uint8) \
        if rng.random() < 0.5 else None
    shadow = (rng.random(shape) < 0.8).astype(np.uint8) \
        if rng.random() < 0.5 else None
    lc = rng.choice(np.array([0, 5, 100, 123, 200, 201, 255],
                             np.uint8), shape) \
        if rng.random() < 0.5 else None
    mode = ['mask', 'ignore', 'cover'][int(rng.integers(0, 3))]
    t = random_thresholds(rng)
    tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}

    cfg = DswxChainConfig(thresholds=t, mask_adjacent_to_cloud_mode=mode)
    got = dswx_chain(*bands, fmask, invalid, cfg, ocean_mask=ocean,
                     shadow_layer=shadow, landcover_mask=lc)
    lists = {0: list(cfg.aerosol_not_water_fmask_values),
             2: list(cfg.aerosol_moderate_conf_fmask_values),
             3: list(cfg.aerosol_psw_conservative_fmask_values),
             4: list(cfg.aerosol_psw_aggressive_fmask_values)}
    want = oracle.full_chain(*bands, fmask, invalid, tdict, mode=mode,
                             aerosol_lists=lists, ocean_mask=ocean,
                             shadow=shadow, landcover=lc)
    for layer in ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF',
                  'CLOUD'):
        a = np.asarray(got[layer])
        b = want[layer]
        if not (a == b).all():
            bad = int((a != b).sum())
            raise AssertionError(
                f'seed={seed} layer={layer} mode={mode} shape={shape} '
                f'regime={regime}: {bad} mismatches; thresholds={tdict}')


def raw_thresholds(rng):
    """Thresholds drawn as raw float64 — almost never exact decimals, so
    these exercise the boundary-exact comparison paths."""
    return HlsThresholds(
        wigt=float(rng.uniform(-0.5, 0.5)),
        awgt=float(rng.uniform(-200, 200)),
        pswt_1_mndwi=float(rng.uniform(-0.9, 0.2)),
        pswt_1_nir=float(rng.uniform(200, 4000)),
        pswt_1_swir1=float(rng.uniform(200, 4000)),
        pswt_1_ndvi=float(rng.uniform(0.1, 0.9)),
        pswt_2_mndwi=float(rng.uniform(-0.9, 0.2)),
        pswt_2_blue=float(rng.uniform(200, 4000)),
        pswt_2_nir=float(rng.uniform(500, 6000)),
        pswt_2_swir1=float(rng.uniform(500, 6000)),
        pswt_2_swir2=float(rng.uniform(200, 4000)),
        lcmask_nir=float(rng.uniform(400, 3000)))


def _boundary_green(swir1_f32, t, rng):
    """float32 green values whose MNDWI vs t sits within a few ULPs of
    the rounding boundary (num/den = (g-s1)/(g+s1))."""
    t32 = np.float64(np.float32(t))
    g0 = (swir1_f32.astype(np.float64) * (1 + t32) / (1 - t32)) \
        .astype(np.float32)
    steps = rng.integers(-3, 4, g0.shape).astype(np.int64)
    out = g0.copy()
    for _ in range(3):
        out = np.where(steps > 0,
                       np.nextafter(out, np.float32(np.inf)), out)
        out = np.where(steps < 0,
                       np.nextafter(out, np.float32(-np.inf)), out)
        steps = steps - np.sign(steps)
    return out.astype(np.float32)


def one_scaled_iteration(seed, ref):
    """Scaled-input (float32) diag + masking parity vs the reference's
    executing code, with boundary-adversarial pixels and non-decimal
    thresholds."""
    from proteus_jax.models.dswx.diagnostics import compute_diagnostic_tests
    from proteus_jax.models.dswx import masking
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(16, 128)), int(rng.integers(16, 128)))
    scale = 0.0001 if rng.random() < 0.7 else float(rng.uniform(1e-5, 1e-3))
    offset = 0.0 if rng.random() < 0.7 else float(rng.uniform(-100, 100))
    bands = [np.float32(scale) * (np.clip(
        rng.integers(-2000, 18000, shape), 1, None)
        .astype(np.float32) - np.float32(offset)) for _ in range(6)]
    t = random_thresholds(rng) if rng.random() < 0.5 else raw_thresholds(rng)
    # adversarial pixels: push green to the MNDWI rounding boundary
    bands[1] = _boundary_green(bands[4], t.wigt, rng)
    tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
    import refbridge
    ref_t = refbridge.reference_thresholds(tdict)
    want = ref._compute_diagnostic_tests(*bands, ref_t)
    got = np.asarray(compute_diagnostic_tests(*bands, t))
    if not (got == want).all():
        raise AssertionError(
            f'scaled seed={seed}: {(got != want).sum()} diag mismatches; '
            f'scale={scale} offset={offset} thresholds={tdict}')
    # scaled-nir masking stages
    cfg = DswxChainConfig()
    wtr1 = np.array([0, 1, 2, 3, 4, 255], np.uint8)[
        rng.integers(0, 6, shape)]
    fmask = rng.integers(0, 256, shape).astype(np.uint8)
    cloud = ref._compute_preliminary_cloud_layer(fmask, 'mask')
    want_w = wtr1.copy()
    want_c = cloud.copy()
    ref._apply_aerosol_class_remapping(
        want_w, bands[3], want_c, fmask,
        list(cfg.aerosol_not_water_fmask_values),
        list(cfg.aerosol_moderate_conf_fmask_values),
        list(cfg.aerosol_psw_conservative_fmask_values),
        list(cfg.aerosol_psw_aggressive_fmask_values))
    got_w, got_c = masking.apply_aerosol_class_remapping(
        wtr1, bands[3], cloud, fmask, cfg.aerosol_lut())
    if not ((np.asarray(got_w) == want_w).all()
            and (np.asarray(got_c) == want_c).all()):
        raise AssertionError(f'scaled aerosol seed={seed}: mismatch')
    lc = np.array([0, 99, 123, 199, 200, 201, 255], np.uint8)[
        rng.integers(0, 7, shape)]
    shad = (rng.random(shape) < 0.5).astype(np.uint8)
    want_l = ref._apply_landcover_and_shadow_masks(
        want_w.copy(), bands[3], lc, shad, ref_t)
    got_l = np.asarray(masking.apply_landcover_and_shadow_masks(
        np.asarray(got_w), bands[3], lc, shad, t))
    if not (got_l == want_l).all():
        raise AssertionError(f'scaled landcover seed={seed}: mismatch')


_DEVICE_SCALE_SHAPE = (2, 48, 64)


def make_device_scale_steps():
    """One (device-scale step, host-cast step) pair, compiled once —
    scales/offsets are traced inputs, so all fuzz iterations share it."""
    from proteus_jax.parallel.campaign import make_campaign_step
    from proteus_jax.parallel.mesh import make_tile_mesh
    mesh = make_tile_mesh()
    cfg = DswxChainConfig()
    return (make_campaign_step(cfg, mesh, float_inputs=True,
                               device_scale=True),
            make_campaign_step(cfg, mesh, float_inputs=True))


def one_device_scale_iteration(seed, steps):
    """Campaign device_scale cast (raw int16 + on-device
    scale*(f32-offset)) vs the host NumPy cast through the same float
    step — bit-identical layers, with green pushed to the MNDWI
    rounding boundary in POST-CAST space so the cast rounding itself is
    what decides the comparisons."""
    step_dev, step_host = steps
    rng = np.random.default_rng(seed)
    B, H, W = _DEVICE_SCALE_SHAPE
    raw = [rng.integers(-2000, 18000, (B, H, W)).astype(np.int16)
           for _ in range(6)]
    scales = np.where(rng.random((B, 6)) < 0.7, 0.0001,
                      rng.uniform(1e-5, 1e-3, (B, 6))).astype(np.float32)
    offsets = np.where(rng.random((B, 6)) < 0.7, 0.0,
                       rng.uniform(-100, 100, (B, 6))).astype(np.float32)
    cast = [scales[:, j, None, None]
            * (raw[j].astype(np.float32) - offsets[:, j, None, None])
            for j in range(6)]
    # adversarial green: invert the boundary float back to raw space so
    # the cast result lands within an ULP or two of the MNDWI boundary
    g_target = _boundary_green(cast[4], HlsThresholds().wigt, rng)
    raw[1] = np.clip(
        np.rint(g_target.astype(np.float64) / scales[:, 1, None, None]
                + offsets[:, 1, None, None]),
        -32768, 32767).astype(np.int16)
    cast[1] = (scales[:, 1, None, None]
               * (raw[1].astype(np.float32) - offsets[:, 1, None, None]))
    fmask = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    invalid = rng.random((B, H, W)) < 0.05
    out_d, tot_d = step_dev(*raw, fmask, invalid, scales, offsets)
    out_h, tot_h = step_host(*cast, fmask, invalid)
    for k in out_h:
        got, want = np.asarray(out_d[k]), np.asarray(out_h[k])
        if not (got == want).all():
            raise AssertionError(
                f'device_scale seed={seed}: {(got != want).sum()} '
                f'{k} mismatches')
    if int(tot_d['n_valid_total']) != int(tot_h['n_valid_total']):
        raise AssertionError(f'device_scale seed={seed}: totals differ')


def one_nondecimal_iteration(seed, ref):
    """Integer-path diag parity with raw (non-decimal) float64 thresholds
    — exercises the boundary-exact float64 comparisons."""
    from proteus_jax.models.dswx.diagnostics import compute_diagnostic_tests
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(16, 128)), int(rng.integers(16, 128)))
    bands = [rng.integers(-32768, 32767, shape).astype(np.int16)
             for _ in range(6)]
    t = raw_thresholds(rng)
    # engineered: green lands within +-2 of the exact MNDWI boundary
    s1 = np.clip(np.abs(bands[4]).astype(np.int64), 1, None)
    g0 = np.round(s1 * (1 + t.wigt) / (1 - t.wigt))
    bands[1] = np.clip(g0 + rng.integers(-2, 3, shape), -32768, 32767) \
        .astype(np.int16)
    bands[4] = np.clip(s1, None, 32767).astype(np.int16)
    tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
    import refbridge
    want = ref._compute_diagnostic_tests(
        *bands, refbridge.reference_thresholds(tdict))
    got = np.asarray(compute_diagnostic_tests(*bands, t))
    if not (got == want).all():
        raise AssertionError(
            f'nondecimal seed={seed}: {(got != want).sum()} mismatches; '
            f'thresholds={tdict}')


def one_warp_iteration(seed, tmpdir):
    """Device warp vs host float64 warp: bit-equality fuzz over random
    sources (dtype, nodata, resolution) and tile grids, all three
    resampling kernels."""
    import tempfile
    from proteus_jax.io.cog import write_cog
    from proteus_jax.geo.warp import warp_to_grid, warp_to_grid_device
    rng = np.random.default_rng(seed)
    wrap_source = rng.random() < 0.25
    # projected (non-geographic) source CRS in ~30% of non-wrap
    # iterations: the round-3 widened grids whose domain covers the
    # fuzz tile (~31.5N 92.5W) — Conus Albers, Canada Atlas LCC,
    # NAD83 UTM, EASE-Grid 2.0 North, and NAD27 UTM (26715: exercises
    # the TOWGS84 Helmert datum path through the warp)
    src_epsg = 4326
    if not wrap_source and rng.random() < 0.3:
        src_epsg = int(rng.choice([5070, 3978, 26915, 6931, 26715]))
    if wrap_source:
        # global 360-deg raster (wraps in longitude) + a UTM zone-1
        # tile whose margin crosses the antimeridian
        step = float(rng.choice([0.2, 0.25, 0.5]))
        w = int(round(360.0 / step))
        h = int(rng.integers(80, 240))
        gt = (-180.0, step, 0.0, 72.0 + float(rng.uniform(-2, 2)),
              0.0, -step)
    elif src_epsg != 4326:
        h = int(rng.integers(80, 400))
        w = int(rng.integers(80, 400))
        step = float(rng.uniform(50.0, 600.0))   # metres
        # centre the source on the (pre-drawn) tile so footprints
        # genuinely overlap
        tile_x0 = 7.0e5 + float(rng.uniform(-5e4, 5e4))
        tile_y0 = 3.48e6 + float(rng.uniform(-5e4, 5e4))
        from proteus_jax.geo.crs import transform_points
        cx, cy = transform_points(
            'EPSG:32615', f'EPSG:{src_epsg}',
            np.array([tile_x0 + 2000.0]), np.array([tile_y0 - 2000.0]))
        gt = (float(cx[0]) - step * w / 2, step, 0.0,
              float(cy[0]) + step * h / 2, 0.0, -step)
    else:
        h = int(rng.integers(80, 400))
        w = int(rng.integers(80, 400))
        step = float(rng.uniform(0.0005, 0.006))
        gt = (-92.5 + float(rng.uniform(-0.3, 0.3)), step, 0.0,
              31.8 + float(rng.uniform(-0.3, 0.3)), 0.0, -step)
    kind = rng.integers(0, 3)
    if kind == 0:
        arr = (120 * np.sin(np.arange(w)[None, :] / rng.uniform(5, 40))
               * np.cos(np.arange(h)[:, None] / rng.uniform(5, 40))
               + rng.normal(0, rng.uniform(1, 50), (h, w))
               ).astype(np.float32)
        nodata = float('nan')
        if rng.random() < 0.5:
            arr[rng.random((h, w)) < 0.05] = np.nan
    elif kind == 1:
        arr = rng.integers(0, 201, (h, w)).astype(np.uint8)
        nodata = 255
        if rng.random() < 0.5:
            arr[rng.random((h, w)) < 0.05] = 255
    else:
        arr = rng.integers(-2000, 15000, (h, w)).astype(np.int16)
        nodata = -9999
    path = os.path.join(tmpdir, f'warp_src_{seed}.tif')
    write_cog(path, arr, geotransform=gt, epsg=src_epsg, nodata=nodata,
              overview_levels=())
    if wrap_source:
        proj = 'EPSG:32601'  # zone 1: tiles west of the central meridian
        if rng.random() < 0.7:
            # easting ~350000 at ~63-64N puts the tile longitudes ON
            # +-180: kernel footprints genuinely cross the source x wrap
            # boundary (u spans through w), exercising seam-crossing
            # taps — including the masked-renormalization branch when
            # the source carries nodata holes
            tile_gt = (350000.0 + float(rng.uniform(-2.5e4, 1.0e4)),
                       30.0, 0.0,
                       7.05e6 + float(rng.uniform(-5e4, 5e4)), 0.0,
                       -30.0)
        else:
            # near-seam but not crossing (~177E): wrap bookkeeping with
            # in-range u
            tile_gt = (199980.0 + float(rng.uniform(-2e4, 2e4)), 30.0,
                       0.0, 7.0e6 + float(rng.uniform(-3e5, 3e5)), 0.0,
                       -30.0)
    elif src_epsg != 4326:
        proj = 'EPSG:32615'
        tile_gt = (tile_x0, float(rng.choice([10.0, 30.0])), 0.0,
                   tile_y0, 0.0, -float(rng.choice([10.0, 30.0])))
    else:
        proj = 'EPSG:32615'
        tile_gt = (700000.0 + float(rng.uniform(-5e4, 5e4)),
                   float(rng.choice([10.0, 30.0])), 0.0,
                   3.48e6 + float(rng.uniform(-5e4, 5e4)), 0.0,
                   -float(rng.choice([10.0, 30.0])))
    L = int(rng.integers(50, 200))
    Wd = int(rng.integers(50, 200))
    margin = int(rng.choice([0, 10, 50]))
    for alg in ('nearest', 'bilinear', 'cubic'):
        host = warp_to_grid(path, tile_gt, proj, L, Wd,
                            resample_algorithm=alg,
                            margin_in_pixels=margin)
        dev = np.asarray(warp_to_grid_device(
            path, tile_gt, proj, L, Wd,
            resample_algorithm=alg, margin_in_pixels=margin))
        if host.dtype.kind == 'f':
            nn = np.isnan(host) & np.isnan(dev)
            bad = (host != dev) & ~nn
        else:
            bad = host != dev
        if bad.any():
            raise AssertionError(
                f'warp seed={seed} alg={alg} kind={kind}: '
                f'{int(bad.sum())} device-vs-host mismatches')
    os.remove(path)


def one_shadow_iteration(seed, ref):
    """Fuzz compute_opera_shadow_layer_exact against the reference's
    executing float64 chain over synthetic DEMs (smooth, rough, quantized,
    NaN-holed) and sun geometries, including near-tie thresholds."""
    from proteus_jax.models.dswx.shadow import compute_opera_shadow_layer_exact
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(16, 200)), int(rng.integers(16, 200)))
    kind = rng.integers(0, 5)
    if kind == 0:      # smooth correlated terrain
        dem = rng.normal(0, 1, shape).cumsum(0).cumsum(1)
        dem = dem / max(1e-9, np.abs(dem).max()) * rng.uniform(10, 5000)
    elif kind == 1:    # rough noise
        dem = rng.normal(0, rng.uniform(1, 500), shape)
    elif kind == 2:    # quantized (integer-metre DEM) -> exact ties
        dem = rng.integers(0, 50, shape).astype(np.float64) * 30.0
    elif kind == 3:    # flat with NaN holes
        dem = np.full(shape, float(rng.uniform(0, 1000)))
        dem[rng.random(shape) < 0.1] = np.nan
    else:              # sentinel cliffs: huge terrain normals (|tn|~300)
        dem = rng.choice(np.array([-9999.0, 8000.0, 7990.0, 150.0, 0.0]),
                         shape)
    dem = dem.astype(np.float32)
    az = float(rng.uniform(0, 360))
    elev = float(rng.uniform(1, 89))
    mins = float(rng.uniform(-45, 0))
    maxi = float(rng.uniform(1, 89))
    if rng.random() < 0.3:
        maxi = 90.0 - elev  # inc == max_inc ties on flat ground
    want = ref._compute_opera_shadow_layer(dem, az, elev, mins, maxi)
    got = compute_opera_shadow_layer_exact(dem, az, elev, mins,
                                           maxi).astype(bool)
    flips = int((got != want).sum())
    if flips:
        raise AssertionError(
            f'shadow seed={seed} kind={kind} az={az} elev={elev} '
            f'mins={mins} maxi={maxi}: {flips} boolean flips')


def one_hillshade_iteration(seed, ref):
    """Fuzz the otsu branch: device compute_hillshade_exact vs the
    float64 host oracle (bit-identical bytes), and the full otsu shadow
    mask vs the reference's executing _compute_otsu_threshold over
    those bytes."""
    import jax.numpy as jnp
    from proteus_jax.models.dswx.shadow import (
        compute_hillshade_exact, compute_otsu_shadow_layer_exact,
        _host_hillshade_gdal)
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(16, 200)), int(rng.integers(16, 200)))
    kind = rng.integers(0, 5)
    if kind == 0:      # smooth correlated terrain
        dem = rng.normal(0, 1, shape).cumsum(0).cumsum(1)
        dem = dem / max(1e-9, np.abs(dem).max()) * rng.uniform(10, 5000)
    elif kind == 1:    # rough noise
        dem = rng.normal(0, rng.uniform(1, 500), shape)
    elif kind == 2:    # high-altitude plateau: worst f32 cancellation
        dem = (rng.uniform(4000, 8848)
               + rng.normal(0, rng.uniform(0.01, 5), shape))
    elif kind == 3:    # flat with NaN holes
        dem = np.full(shape, float(rng.uniform(0, 1000)))
        dem[rng.random(shape) < 0.1] = np.nan
    else:              # sentinel cliffs incl. f32-overflow magnitudes
        dem = rng.choice(np.array([-9999.0, 8000.0, 150.0, 0.0,
                                   3.0e38, -3.0e38]), shape)
    dem = dem.astype(np.float32)
    az = float(rng.uniform(0, 360))
    elev = float(rng.uniform(1, 89))
    psx = float(rng.choice([30.0, 10.0, 98.425]))
    psy = -psx
    want = _host_hillshade_gdal(dem, az, elev, psx, psy)
    got = np.asarray(compute_hillshade_exact(
        jnp.asarray(dem), az, elev, psx, psy, as_device=True))
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(
            f'hillshade seed={seed} kind={kind} az={az} elev={elev} '
            f'psx={psx}: {bad} byte mismatches vs float64 oracle')
    if ref is not None and np.isfinite(dem).all():
        twant = ref._compute_otsu_threshold(want, is_normalized=True)
        tgot = np.asarray(compute_otsu_shadow_layer_exact(
            jnp.asarray(dem), az, elev, psx, psy))
        flips = int((tgot != twant).sum())
        if flips:
            raise AssertionError(
                f'otsu seed={seed} kind={kind}: {flips} mask flips vs '
                'the reference executing threshold')


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    for i in range(n):
        one_iteration(1000 + i)
        if (i + 1) % 25 == 0:
            print(f'{i + 1}/{n} iterations bit-exact', flush=True)
    print(f'fuzz complete: {n} iterations, all layers bit-exact')

    import tempfile
    warp_dir = tempfile.mkdtemp()
    for i in range(n):
        one_warp_iteration(7000 + i, warp_dir)
        if (i + 1) % 25 == 0:
            print(f'{i + 1}/{n} warp iterations bit-exact', flush=True)
    print(f'warp fuzz complete: {n} iterations, device == host float64 '
          'for nearest/bilinear/cubic')

    steps = make_device_scale_steps()
    for i in range(n):
        one_device_scale_iteration(8000 + i, steps)
        if (i + 1) % 25 == 0:
            print(f'{i + 1}/{n} device-scale iterations bit-exact',
                  flush=True)
    print(f'device-scale fuzz complete: {n} iterations, on-device cast '
          '== host cast through the float step')

    import refbridge
    ref = refbridge.load_reference_dswx()
    if ref is None:
        print('reference checkout unavailable: reference-side fuzz skipped')
        return
    for i in range(n):
        one_scaled_iteration(3000 + i, ref)
        one_nondecimal_iteration(4000 + i, ref)
        if (i + 1) % 25 == 0:
            print(f'{i + 1}/{n} scaled+nondecimal iterations bit-exact',
                  flush=True)
    print(f'scaled+nondecimal fuzz complete: {n} iterations each, '
          'bit-exact vs the reference executing code')
    for i in range(n):
        one_shadow_iteration(5000 + i, ref)
        if (i + 1) % 25 == 0:
            print(f'{i + 1}/{n} shadow iterations bit-exact', flush=True)
    print(f'shadow fuzz complete: {n} iterations, 0 boolean flips vs the '
          'reference float64 chain')
    for i in range(n):
        one_hillshade_iteration(9000 + i, ref)
        if (i + 1) % 25 == 0:
            print(f'{i + 1}/{n} hillshade+otsu iterations bit-exact',
                  flush=True)
    print(f'hillshade+otsu fuzz complete: {n} iterations, device bytes '
          '== float64 oracle, masks == reference executing threshold')


if __name__ == '__main__':
    main()
