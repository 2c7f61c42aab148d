"""Bit-exactness tests: the device chain vs the NumPy float64 oracle."""

import numpy as np
import pytest

import oracle

from proteus_jax.core import constants as C
from proteus_jax.core.thresholds import HlsThresholds
from proteus_jax.models.dswx.chain import DswxChainConfig, dswx_chain
from proteus_jax.models.dswx.diagnostics import (compute_diagnostic_tests,
                                                 get_binary_representation)
from proteus_jax.models.dswx.interpretation import (generate_interpreted_layer,
                                                    collapse_wtr_classes)
from proteus_jax.models.dswx import masking
from proteus_jax.models.dswx.shadow import compute_opera_shadow_layer
from proteus_jax.models.dswx.landcover import create_landcover_mask_arrays

RNG = np.random.default_rng(42)
T = HlsThresholds()
TDICT = {k: getattr(T, k) for k in T.__dataclass_fields__}


def random_bands(shape=(64, 64), lo=-2000, hi=18000):
    return [RNG.integers(lo, hi, size=shape).astype(np.int16)
            for _ in range(6)]


def clipped(bands):
    # ingest applies FLAG_CLIP_NEGATIVE_REFLECTANCE (clip to >= 1)
    return [np.clip(b, 1, None) for b in bands]


class TestDiagnostics:
    def test_random_parity(self):
        bands = clipped(random_bands((128, 128)))
        got = np.asarray(compute_diagnostic_tests(*bands, T))
        want = oracle.diagnostic_tests(*bands, TDICT)
        np.testing.assert_array_equal(got, want)

    def test_overflow_wrap_parity(self):
        # values that overflow int16 sums (green+swir1 etc.)
        bands = [RNG.integers(15000, 32767, size=(64, 64)).astype(np.int16)
                 for _ in range(6)]
        got = np.asarray(compute_diagnostic_tests(*bands, T))
        want = oracle.diagnostic_tests(*bands, TDICT)
        np.testing.assert_array_equal(got, want)

    def test_zero_denominator_parity(self):
        # force green + swir1 == 0 and nir + red == 0 (inf/NaN semantics)
        shape = (8, 8)
        green = RNG.integers(-100, 100, shape).astype(np.int16)
        swir1 = (-green).astype(np.int16)
        nir = RNG.integers(-100, 100, shape).astype(np.int16)
        red = (-nir).astype(np.int16)
        blue = RNG.integers(1, 100, shape).astype(np.int16)
        swir2 = RNG.integers(1, 100, shape).astype(np.int16)
        bands = [blue, green, red, nir, swir1, swir2]
        got = np.asarray(compute_diagnostic_tests(*bands, T))
        want = oracle.diagnostic_tests(*bands, TDICT)
        np.testing.assert_array_equal(got, want)

    def test_exact_threshold_boundary(self):
        # mndwi exactly equal to wigt = 0.124 = 31/250: strict > must be False
        green = np.full((4, 4), 281, np.int16)   # g - s1 = 62, g + s1 = 500
        swir1 = np.full((4, 4), 219, np.int16)   # 62/500 == 0.124
        blue = np.full((4, 4), 1, np.int16)
        red = np.full((4, 4), 1, np.int16)
        nir = np.full((4, 4), 5000, np.int16)
        swir2 = np.full((4, 4), 5000, np.int16)
        bands = [blue, green, red, nir, swir1, swir2]
        got = np.asarray(compute_diagnostic_tests(*bands, T))
        want = oracle.diagnostic_tests(*bands, TDICT)
        np.testing.assert_array_equal(got, want)
        assert not (got & 1).any()  # test 1 false at exact equality

    def test_near_threshold_sweep(self):
        # scan denominators and numerators bracketing each ratio threshold
        dens = np.arange(1, 4000, dtype=np.int64)
        for t in (T.wigt, T.pswt_1_mndwi, T.pswt_2_mndwi, T.pswt_1_ndvi):
            nums = np.round(t * dens).astype(np.int64)
            for delta in (-1, 0, 1):
                num = nums + delta
                den = dens
                green = ((den + num) // 2)
                swir1 = den - green
                ok = (np.abs(green) < 32768) & (np.abs(swir1) < 32768) & \
                     ((green - swir1) == num)
                g = green[ok].astype(np.int16).reshape(1, -1)
                s1 = swir1[ok].astype(np.int16).reshape(1, -1)
                blue = np.ones_like(g)
                bands = [blue, g, blue, blue, s1, blue]
                got = np.asarray(compute_diagnostic_tests(*bands, T))
                want = oracle.diagnostic_tests(*bands, TDICT)
                np.testing.assert_array_equal(got, want)

    def test_float_input_path(self):
        bands = [b.astype(np.float32) * 1e-4 for b in
                 clipped(random_bands((32, 32)))]
        got = np.asarray(compute_diagnostic_tests(*bands, T))
        want = oracle.diagnostic_tests(*[b.astype(np.float64) for b in bands],
                                       TDICT)
        # float32 vs float64: allow only boundary-straddling mismatches
        assert (got != want).mean() < 1e-3


class TestInterpretation:
    def test_lut_reference_unit_test(self):
        # mirrors the reference unit test (tests/test_dswx_hls_units.py)
        keys = list(C.INTERPRETED_DSWX_BAND_DICT)
        arr = np.array(keys + [31999], dtype=np.uint16).reshape(1, -1)
        # 31999 won't occur on device (diag <= 32) but LUT contract: unknown
        # in-range values -> fill
        got = np.asarray(generate_interpreted_layer(arr))
        want = np.array([C.INTERPRETED_DSWX_BAND_DICT[k] for k in keys]
                        + [255], dtype=np.uint8).reshape(1, -1)
        np.testing.assert_array_equal(got, want)

    def test_binary_representation(self):
        diag = np.arange(33, dtype=np.uint16).reshape(1, -1)
        got = np.asarray(get_binary_representation(diag))
        want = oracle.binary_representation(diag)
        np.testing.assert_array_equal(got, want)

    def test_collapse(self):
        layer = np.arange(256, dtype=np.uint8).reshape(16, 16)
        got = np.asarray(collapse_wtr_classes(layer))
        want = oracle.collapse(layer)
        np.testing.assert_array_equal(got, want)


class TestMasking:
    def test_preliminary_cloud(self):
        fmask = RNG.integers(0, 256, (64, 64)).astype(np.uint8)
        for mode in ('mask', 'ignore', 'cover'):
            got = np.asarray(
                masking.compute_preliminary_cloud_layer(fmask, mode))
            want = oracle.preliminary_cloud(fmask, mode)
            np.testing.assert_array_equal(got, want)

    def test_snow_cover_dilation(self):
        fmask = RNG.integers(0, 256, (96, 96)).astype(np.uint8)
        wtr2 = RNG.integers(0, 6, (96, 96)).astype(np.uint8)
        wtr2[RNG.random((96, 96)) < 0.05] = 255
        for mode in ('mask', 'ignore', 'cover'):
            cloud = oracle.preliminary_cloud(fmask, mode)
            got = np.asarray(masking.add_snow_to_cloud_layer(
                wtr2, cloud, fmask, mode))
            want = oracle.add_snow(wtr2, cloud, fmask, mode)
            np.testing.assert_array_equal(got, want)

    def test_aerosol(self):
        cfg = DswxChainConfig()
        fmask = RNG.integers(0, 256, (64, 64)).astype(np.uint8)
        nir = RNG.integers(1, 3000, (64, 64)).astype(np.int16)
        wtr1 = RNG.integers(0, 6, (64, 64)).astype(np.uint8)
        cloud = oracle.preliminary_cloud(fmask, 'mask')
        got_w, got_c = masking.apply_aerosol_class_remapping(
            wtr1, nir, cloud, fmask, cfg.aerosol_lut())
        lists = {0: cfg.aerosol_not_water_fmask_values,
                 2: cfg.aerosol_moderate_conf_fmask_values,
                 3: cfg.aerosol_psw_conservative_fmask_values,
                 4: cfg.aerosol_psw_aggressive_fmask_values}
        want_w, want_c = oracle.aerosol_remap(wtr1, nir, cloud, fmask, lists)
        np.testing.assert_array_equal(np.asarray(got_w), want_w)
        np.testing.assert_array_equal(np.asarray(got_c), want_c)

    def test_landcover_shadow(self):
        nir = RNG.integers(1, 3000, (64, 64)).astype(np.int16)
        interp = RNG.integers(0, 6, (64, 64)).astype(np.uint8)
        shadow = (RNG.random((64, 64)) < 0.3).astype(np.uint8)
        lc = RNG.choice(np.array([0, 5, 100, 123, 200, 201, 255],
                                 dtype=np.uint8), (64, 64))
        for use_lc in (None, lc):
            for use_sh in (None, shadow):
                got = np.asarray(masking.apply_landcover_and_shadow_masks(
                    interp, nir, use_lc, use_sh, T))
                want = oracle.landcover_shadow_masks(
                    interp, nir, use_lc, use_sh, TDICT)
                np.testing.assert_array_equal(got, want)


class TestFullChain:
    @pytest.mark.parametrize('mode', ['mask', 'ignore', 'cover'])
    def test_chain_parity(self, mode):
        shape = (96, 96)
        bands = clipped(random_bands(shape))
        fmask = RNG.integers(0, 256, shape).astype(np.uint8)
        invalid = RNG.random(shape) < 0.05
        ocean = (RNG.random(shape) < 0.9).astype(np.uint8)
        shadow = (RNG.random(shape) < 0.8).astype(np.uint8)
        lc = RNG.choice(np.array([0, 100, 200, 201, 255], dtype=np.uint8),
                        shape)

        cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
        got = dswx_chain(*bands, fmask, invalid, cfg, ocean_mask=ocean,
                         shadow_layer=shadow, landcover_mask=lc)

        lists = {0: cfg.aerosol_not_water_fmask_values,
                 2: cfg.aerosol_moderate_conf_fmask_values,
                 3: cfg.aerosol_psw_conservative_fmask_values,
                 4: cfg.aerosol_psw_aggressive_fmask_values}
        want = oracle.full_chain(*bands, fmask, invalid, TDICT, mode=mode,
                                 aerosol_lists=lists, ocean_mask=ocean,
                                 shadow=shadow, landcover=lc)
        for layer in ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF',
                      'CLOUD'):
            np.testing.assert_array_equal(np.asarray(got[layer]),
                                          want[layer], err_msg=layer)

        # coverage counters
        valid = (~invalid) & (ocean != 0)
        assert int(got['n_valid']) == int(valid.sum())
        prelim = oracle.preliminary_cloud(fmask, mode)
        assert int(got['n_cloud_and_valid']) == int(
            ((prelim != 0) & valid).sum())
        assert int(got['n_not_ocean']) == int((ocean != 0).sum())

    def test_chain_minimal_no_ancillaries(self):
        shape = (64, 64)
        bands = clipped(random_bands(shape))
        fmask = RNG.integers(0, 256, shape).astype(np.uint8)
        invalid = np.zeros(shape, bool)
        cfg = DswxChainConfig(apply_aerosol_class_remapping=False)
        got = dswx_chain(*bands, fmask, invalid, cfg)
        want = oracle.full_chain(*bands, fmask, invalid, TDICT)
        for layer in ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF',
                      'CLOUD'):
            np.testing.assert_array_equal(np.asarray(got[layer]),
                                          want[layer], err_msg=layer)


class TestShadowAndLandcover:
    def test_opera_shadow(self):
        # smooth synthetic terrain; booleans must match the float64 oracle
        y, x = np.mgrid[0:128, 0:128]
        dem = (200 * np.sin(x / 17.0) * np.cos(y / 23.0)
               + 0.5 * x + 30 * np.exp(-((x - 60) ** 2 + (y - 70) ** 2)
                                       / 400.0)).astype(np.float32)
        got = np.asarray(compute_opera_shadow_layer(dem, 127.5, 37.2,
                                                    -5.0, 40.0))
        want = oracle.opera_shadow(dem.astype(np.float64), 127.5, 37.2,
                                   -5.0, 40.0)
        # float32 vs float64 may flip razor-edge pixels only
        assert (got != want).mean() < 1e-4

    def test_landcover_mask(self):
        h = w = 33
        cgls = RNG.choice(np.array([20, 50, 111, 0, 40], dtype=np.uint8),
                          (h, w))
        wc3 = RNG.choice(np.array([10, 50, 80, 90, 95, 30], dtype=np.uint8),
                         (3 * h, 3 * w))
        forest = [20, 50, 111, 113, 115, 116, 121, 123, 125, 126]
        for mask_type in ('standard', 'water heavy'):
            got = np.asarray(create_landcover_mask_arrays(
                cgls, wc3, mask_type, forest, worldcover_year=2021))
            want = oracle.landcover_mask(cgls, wc3, mask_type, forest,
                                         year=2021)
            np.testing.assert_array_equal(got, want)


class TestResample30m:
    """BASELINE config 2: raw Sentinel-2 10 m / 20 m -> 30 m ingest."""

    def test_10m_exact_mean(self):
        from proteus_jax.ops.resample import resample_to_30m
        x = np.arange(36, dtype=np.int16).reshape(6, 6)
        out = np.asarray(resample_to_30m(x, 10))
        assert out.shape == (2, 2)
        np.testing.assert_allclose(
            out, x.reshape(2, 3, 2, 3).mean(axis=(1, 3)))

    def test_20m_rational_resample(self):
        from proteus_jax.ops.resample import resample_to_30m
        x = np.arange(16, dtype=np.float32).reshape(4, 4)
        out = np.asarray(resample_to_30m(x, 20))
        assert out.shape == (6, 6)
        # total mass preserved by area weighting (each source pixel's
        # 9 copies are pooled into 2x2 windows; mean of all outputs
        # equals mean of inputs)
        assert float(out.mean()) == pytest.approx(float(x.mean()))

    def test_30m_identity(self):
        from proteus_jax.ops.resample import resample_to_30m
        x = np.arange(9, dtype=np.int16).reshape(3, 3)
        np.testing.assert_array_equal(np.asarray(resample_to_30m(x, 30)),
                                      x)


class TestScaledMode:
    """flag_offset_and_scale_inputs=True: float32 reflectance path."""

    def test_scaled_chain_close_to_oracle(self):
        shape = (96, 96)
        bands_i = clipped(random_bands(shape))
        bands_f = [b.astype(np.float32) * np.float32(1e-4)
                   for b in bands_i]
        fmask = RNG.integers(0, 256, shape).astype(np.uint8)
        invalid = np.zeros(shape, bool)
        cfg = DswxChainConfig(apply_aerosol_class_remapping=False)
        got = dswx_chain(*bands_f, fmask, invalid, cfg)
        want = oracle.full_chain(*[b.astype(np.float64) for b in bands_f],
                                 fmask, invalid, TDICT)
        # float32 vs float64: only boundary-straddling pixels may differ
        for layer in ('WTR', 'DIAG'):
            frac = (np.asarray(got[layer]) != want[layer]).mean()
            assert frac < 2e-3, (layer, frac)


class TestCustomThresholds:
    def test_threshold_propagation(self):
        """Non-default thresholds flow through the exact-rational engine
        and change the result in agreement with the oracle."""
        t = HlsThresholds(wigt=0.2, pswt_1_nir=1200, awgt=0.05)
        tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
        bands = clipped(random_bands((64, 64)))
        got = np.asarray(compute_diagnostic_tests(*bands, t))
        want = oracle.diagnostic_tests(*bands, tdict)
        np.testing.assert_array_equal(got, want)
        default = np.asarray(compute_diagnostic_tests(
            *bands, HlsThresholds()))
        assert (got != default).any()

    def test_irrational_threshold_falls_back_to_float(self):
        import math
        t = HlsThresholds(wigt=math.pi / 25)  # not an exact decimal
        bands = clipped(random_bands((32, 32)))
        got = np.asarray(compute_diagnostic_tests(*bands, t))
        tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
        want = oracle.diagnostic_tests(*bands, tdict)
        assert (got != want).mean() < 1e-2  # float32 fallback tolerance


class TestOtsuParity:
    def test_otsu_matches_numpy_histogram_semantics(self):
        """Device Otsu equals a NumPy re-derivation of the reference
        algorithm (256 bins over [min,max], argmax inter-class var)."""
        x = (RNG.normal(120, 40, (128, 128)) +
             80 * (RNG.random((128, 128)) > 0.6)).astype(np.float32)
        hist, edges = np.histogram(x, bins=256)
        mids = 0.5 * (edges[:-1] + edges[1:])
        w1 = np.cumsum(hist)
        w2 = np.cumsum(hist[::-1])[::-1]
        with np.errstate(invalid='ignore', divide='ignore'):
            m1 = np.cumsum(hist * mids) / w1
            m2 = (np.cumsum((hist * mids)[::-1]) / w2[::-1])[::-1]
            icv = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
        thr = mids[:-1][np.nanargmax(icv)]
        want = x > thr
        from proteus_jax.ops.otsu import otsu_binarize
        got = np.asarray(otsu_binarize(x))
        assert (got != want).mean() < 1e-3  # f32 binning edge pixels only


class TestMorphologyDisk:
    def test_dilate_disk_matches_scipy_edt(self):
        from scipy.ndimage import distance_transform_edt
        from proteus_jax.ops.morphology import dilate_disk
        x = np.zeros((48, 48), bool)
        x[20, 20] = True
        x[5, 40] = True
        r = 6.0
        got = np.asarray(dilate_disk(x, r))
        want = distance_transform_edt(~x) <= r
        np.testing.assert_array_equal(got, want)


class TestHillshadeAnalytic:
    def test_flat_dem_constant_hillshade(self):
        from proteus_jax.models.dswx.shadow import compute_hillshade
        dem = np.full((32, 32), 500.0, np.float32)
        hs = np.asarray(compute_hillshade(dem, 135.0, 45.0))
        v = np.float32(1.0 + 254.0 * np.sin(np.radians(45.0)))
        want = int(np.trunc(v + np.float32(0.5)))
        # GDAL edge semantics: 1-px border ring is dst nodata 0
        assert (hs[1:-1, 1:-1] == want).all()
        assert (hs[0, :] == 0).all() and (hs[:, -1] == 0).all()

    def test_sun_facing_slope_brighter(self):
        from proteus_jax.models.dswx.shadow import compute_hillshade
        yy, xx = np.mgrid[0:64, 0:64]
        # slope dipping to the east; sun from the east (az=90) lights it
        dem_east = (-(xx.astype(np.float32)) * 10.0)
        hs_lit = np.asarray(compute_hillshade(dem_east, 90.0, 30.0))
        hs_dark = np.asarray(compute_hillshade(dem_east, 270.0, 30.0))
        assert hs_lit[32, 32] > hs_dark[32, 32]

    def test_flat_dem_shadow_depends_on_sun_elevation(self):
        from proteus_jax.models.dswx.shadow import \
            compute_opera_shadow_layer
        dem = np.full((32, 32), 100.0, np.float32)
        # flat ground: local incidence angle == solar zenith angle
        # zenith 30 (elev 60) <= max 40 -> "not shadow" mask True
        shad = np.asarray(compute_opera_shadow_layer(dem, 100.0, 60.0,
                                                     -5.0, 40.0))
        assert shad.all()
        # zenith 80 (elev 10) > 40 and directional slope 0 > min(-5):
        # mask stays True through the backslope branch
        shad2 = np.asarray(compute_opera_shadow_layer(dem, 100.0, 10.0,
                                                      -5.0, 40.0))
        assert shad2.all()


class TestHillshadeExact:
    """compute_hillshade_exact (device f32 + epsilon-band host resolve)
    must be bit-identical to the float64 GDAL-semantics oracle
    `_host_hillshade_gdal` (reference otsu branch: dswx_hls.py:4177-4212
    via gdal.DEMProcessing hillshade, Horn, no computeEdges)."""

    @staticmethod
    def _terrain(seed, shape=(128, 128), scale=800.0):
        rng = np.random.default_rng(seed)
        base = rng.normal(0, 1, shape).cumsum(axis=0).cumsum(axis=1)
        return (base / np.abs(base).max() * scale + 200).astype(
            np.float32)

    def test_device_matches_host_oracle(self):
        import jax.numpy as jnp
        from proteus_jax.models.dswx.shadow import (
            compute_hillshade_exact, _host_hillshade_gdal)
        for seed, az, elev in [(0, 135.0, 45.0), (1, 277.3, 18.0),
                               (2, 90.0, 75.0), (3, 0.0, 2.0)]:
            dem = self._terrain(seed)
            want = _host_hillshade_gdal(dem, az, elev, 30.0, -30.0)
            got = np.asarray(compute_hillshade_exact(
                jnp.asarray(dem), az, elev, as_device=True))
            np.testing.assert_array_equal(got, want)
            host_ret = compute_hillshade_exact(jnp.asarray(dem), az,
                                               elev)
            assert isinstance(host_ret, np.ndarray)
            np.testing.assert_array_equal(host_ret, want)

    def test_quadratic_ramp_boundary_sweep(self):
        """Smoothly varying slope: v = 1 + 254*cang sweeps through
        dozens of x.5 round-half boundaries — the regime where a plain
        f32 chain flips bytes vs the f64 oracle."""
        import jax.numpy as jnp
        from proteus_jax.models.dswx.shadow import (
            compute_hillshade_exact, _host_hillshade_gdal)
        col = np.arange(2048, dtype=np.float64)
        dem = (0.01 * col ** 2).astype(np.float32)[None, :].repeat(
            8, axis=0)
        for az, elev in [(90.0, 45.0), (270.0, 30.0), (135.0, 60.0)]:
            want = _host_hillshade_gdal(dem, az, elev, 30.0, -30.0)
            got = np.asarray(compute_hillshade_exact(
                jnp.asarray(dem), az, elev, as_device=True))
            np.testing.assert_array_equal(got, want)
        # sanity: the sweep really does cover a wide byte range
        assert len(np.unique(want[1:-1, 1:-1])) > 50

    def test_nan_and_f32_overflow_windows(self):
        """NaN windows pin to byte 0; finite float32 DEM values whose
        Horn sums overflow ONLY the f32 intermediates must be resolved
        against the (non-overflowing) f64 oracle."""
        import jax.numpy as jnp
        from proteus_jax.models.dswx.shadow import (
            compute_hillshade_exact, _host_hillshade_gdal)
        dem = self._terrain(7, (64, 64))
        dem[10:14, 20:24] = np.nan
        dem[40, 40] = np.float32(3.0e38)
        dem[41, 45] = np.float32(-3.0e38)
        want = _host_hillshade_gdal(dem, 135.0, 45.0, 30.0, -30.0)
        got = np.asarray(compute_hillshade_exact(
            jnp.asarray(dem), 135.0, 45.0, as_device=True))
        np.testing.assert_array_equal(got, want)

    def test_fallback_full_host_recompute(self, monkeypatch):
        """Band budget overflow falls back to the full host oracle."""
        import jax.numpy as jnp
        from proteus_jax.models.dswx import shadow as sh
        monkeypatch.setattr(sh, '_MAX_UNCERTAIN_HS', 0)
        dem = self._terrain(5, (32, 32))
        want = sh._host_hillshade_gdal(dem, 135.0, 45.0, 30.0, -30.0)
        got = np.asarray(sh.compute_hillshade_exact(
            jnp.asarray(dem), 135.0, 45.0, as_device=True))
        np.testing.assert_array_equal(got, want)



def test_make_jitted_chain_helper():
    from proteus_jax.models.dswx.chain import make_jitted_chain
    cfg = DswxChainConfig()
    fn = make_jitted_chain(cfg, with_shadow=True, compute_browse=False)
    bands = clipped(random_bands((32, 32)))
    fmask = RNG.integers(0, 256, (32, 32)).astype(np.uint8)
    invalid = np.zeros((32, 32), bool)
    shadow = (RNG.random((32, 32)) < 0.8).astype(np.uint8)
    out = fn(*bands, fmask, invalid, shadow)
    want = dswx_chain(*bands, fmask, invalid, cfg, shadow_layer=shadow,
                      compute_browse=False)
    np.testing.assert_array_equal(np.asarray(out['WTR']),
                                  np.asarray(want['WTR']))
