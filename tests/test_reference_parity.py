"""Bit-exactness vs the reference's OWN executing code (not our oracle).

Round 1 validated the device chain against tests/oracle.py — this repo's
re-implementation of the reference semantics — leaving a loophole: a shared
misreading of dswx_hls.py would pass every test. These tests close it by
importing /root/reference/src/proteus/dswx_hls.py through tests/refbridge.py
(GDAL et al. stubbed) and executing the reference's real NumPy science
functions as the expected side of every comparison.

Covered (reference file:line):
- _compute_diagnostic_tests        dswx_hls.py:1840
- generate_interpreted_layer       dswx_hls.py:1687
- _get_binary_representation       dswx_hls.py:4286
- _compute_preliminary_cloud_layer dswx_hls.py:1919
- _apply_aerosol_class_remapping   dswx_hls.py:1249
- _apply_landcover_and_shadow_masks dswx_hls.py:1305
- _add_snow_to_cloud_layer ('mask' and 'cover') dswx_hls.py:1996
- _apply_cloud_masking             dswx_hls.py:2089
- _get_binary_water_layer          dswx_hls.py:1710
- _get_confidence_layer            dswx_hls.py:1733
- _collapse_wtr_classes            dswx_hls.py:2578
- _compute_browse_array            dswx_hls.py:3057
- _compute_opera_shadow_layer      dswx_hls.py:4215
- _compute_otsu_threshold          dswx_hls.py:1638
- decimate_by_summation / _update_landcover_array dswx_hls.py:874,906
- _crop_2d_array_all_sides         dswx_hls.py:4320
- full orchestrator stage ordering dswx_hls.py:5225-5368
"""

import numpy as np
import pytest

import oracle
import refbridge

from proteus_jax.core import constants as C
from proteus_jax.core.thresholds import HlsThresholds
from proteus_jax.models.dswx.chain import DswxChainConfig, dswx_chain
from proteus_jax.models.dswx.diagnostics import (compute_diagnostic_tests,
                                                 get_binary_representation)
from proteus_jax.models.dswx.interpretation import (generate_interpreted_layer,
                                                    get_binary_water_layer,
                                                    get_confidence_layer,
                                                    collapse_wtr_classes)
from proteus_jax.models.dswx import masking
from proteus_jax.models.dswx.browse import compute_browse_array
from proteus_jax.models.dswx.landcover import create_landcover_mask_arrays
from proteus_jax.models.dswx.shadow import (compute_opera_shadow_layer_exact,
                                            _decision_boundaries)
from proteus_jax.ops.otsu import otsu_binarize

REF = refbridge.load_reference_dswx()

pytestmark = pytest.mark.skipif(
    REF is None, reason='reference checkout not available')

RNG = np.random.default_rng(20260816)
T = HlsThresholds()
TDICT = {k: getattr(T, k) for k in T.__dataclass_fields__}


def ref_thresholds():
    return refbridge.reference_thresholds(TDICT)


def random_bands(shape, lo=-2000, hi=18000, rng=RNG):
    return [rng.integers(lo, hi, size=shape).astype(np.int16)
            for _ in range(6)]


def random_fmask(shape, rng=RNG):
    """Mix of realistic HLS Fmask values and raw random bytes."""
    realistic = np.array([0, 2, 4, 6, 8, 16, 64, 66, 68, 80, 96, 128,
                          130, 160, 192, 224, 240, 255], dtype=np.uint8)
    pick = rng.integers(0, len(realistic), size=shape)
    fmask = realistic[pick]
    raw = rng.integers(0, 256, size=shape).astype(np.uint8)
    use_raw = rng.random(shape) < 0.25
    return np.where(use_raw, raw, fmask).astype(np.uint8)


def random_wtr_layer(shape, rng=RNG):
    vals = np.array([0, 1, 2, 3, 4, C.WTR_OCEAN_MASKED, C.UINT8_FILL_VALUE],
                    dtype=np.uint8)
    return vals[rng.integers(0, len(vals), size=shape)]


class TestPerStageParity:
    def test_diagnostic_tests(self):
        for lo, hi in [(-2000, 18000), (15000, 32767), (-32768, 32767)]:
            bands = random_bands((96, 96), lo, hi)
            want = REF._compute_diagnostic_tests(*bands, ref_thresholds())
            got = np.asarray(compute_diagnostic_tests(*bands, T))
            np.testing.assert_array_equal(got, want)

    def test_diagnostic_tests_zero_denominators(self):
        shape = (16, 16)
        green = RNG.integers(-100, 100, shape).astype(np.int16)
        swir1 = (-green).astype(np.int16)
        nir = RNG.integers(-100, 100, shape).astype(np.int16)
        red = (-nir).astype(np.int16)
        blue = RNG.integers(1, 100, shape).astype(np.int16)
        swir2 = RNG.integers(1, 100, shape).astype(np.int16)
        bands = [blue, green, red, nir, swir1, swir2]
        want = REF._compute_diagnostic_tests(*bands, ref_thresholds())
        got = np.asarray(compute_diagnostic_tests(*bands, T))
        np.testing.assert_array_equal(got, want)

    def test_diagnostic_tests_scaled_inputs(self):
        """--offset-and-scale-inputs mode: the reference ingest casts to
        float32 (dswx_hls.py:2298-2302, `scale * (float32(image) - offset)`),
        so under NumPy 2 its whole scaled diag chain stays float32 — and so
        does ours. Includes a ULP scan across the MNDWI threshold."""
        for _ in range(5):
            bands = [(0.0001 * (np.clip(
                RNG.integers(-2000, 18000, (128, 128)), 1, None)
                .astype(np.float32) - 0.0)) for _ in range(6)]
            want = REF._compute_diagnostic_tests(*bands, ref_thresholds())
            got = np.asarray(compute_diagnostic_tests(*bands, T))
            np.testing.assert_array_equal(got, want)

        # adversarial: green walks f32 ULPs across mndwi == wigt
        s1 = np.float32(0.09)
        g0 = np.float32(s1 * (1 + T.wigt) / (1 - T.wigt))
        gs, lo, hi = [g0], g0, g0
        for _ in range(2000):
            lo = np.nextafter(lo, np.float32(0), dtype=np.float32)
            hi = np.nextafter(hi, np.float32(1), dtype=np.float32)
            gs += [lo, hi]
        g = np.array(gs, dtype=np.float32).reshape(1, -1)
        ones = np.full_like(g, 0.5)
        bands = [ones, g, ones, ones, np.full_like(g, s1), ones]
        want = REF._compute_diagnostic_tests(*bands, ref_thresholds())
        got = np.asarray(compute_diagnostic_tests(*bands, T))
        np.testing.assert_array_equal(got, want)

    def test_diagnostic_tests_nondecimal_thresholds(self):
        """Thresholds with no exact decimal fraction (e.g. 1/3) take the
        boundary-exact float64-semantics path instead of the rational
        rewrite; the reference computes int16/int16 in float64."""
        t = T.replace(wigt=1 / 3, awgt=1 / 7, pswt_1_ndvi=-2 / 7,
                      pswt_1_swir1=900.5 + 1e-11, pswt_2_blue=1000 - 1e-9,
                      pswt_1_mndwi=-0.44 + 1e-13, pswt_2_mndwi=np.nextafter(
                          -0.5, 0.0))
        tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
        ref_t = refbridge.reference_thresholds(tdict)
        for lo, hi in [(-2000, 18000), (-32768, 32767)]:
            bands = random_bands((96, 96), lo, hi)
            want = REF._compute_diagnostic_tests(*bands, ref_t)
            got = np.asarray(compute_diagnostic_tests(*bands, t))
            np.testing.assert_array_equal(got, want)
        # engineered: mndwi within +-2 of the 1/3 boundary for every den
        s1 = RNG.integers(1, 16000, (64, 64)).astype(np.int64)
        g0 = np.round(s1 * (1 + 1 / 3) / (1 - 1 / 3)).astype(np.int64)
        for dg in (-2, -1, 0, 1, 2):
            g = np.clip(g0 + dg, -32768, 32767).astype(np.int16)
            bands = [np.full_like(g, 500), g, np.full_like(g, 400),
                     np.full_like(g, 700), np.clip(s1, None, 32767)
                     .astype(np.int16), np.full_like(g, 600)]
            want = REF._compute_diagnostic_tests(*bands, ref_t)
            got = np.asarray(compute_diagnostic_tests(*bands, t))
            np.testing.assert_array_equal(got, want)

    def test_diagnostic_tests_scaled_boundary_scans(self):
        """ULP scans across every ratio-test boundary in scaled mode:
        NDVI < pswt_1_ndvi and MNDWI > pswt_1/2_mndwi (wigt is covered by
        test_diagnostic_tests_scaled_inputs)."""
        def scan(center, toward_lo, toward_hi, n=1500):
            vals, lo, hi = [np.float32(center)], np.float32(center), \
                np.float32(center)
            for _ in range(n):
                lo = np.nextafter(lo, np.float32(toward_lo),
                                  dtype=np.float32)
                hi = np.nextafter(hi, np.float32(toward_hi),
                                  dtype=np.float32)
                vals += [lo, hi]
            return np.array(vals, dtype=np.float32).reshape(1, -1)

        # NDVI boundary: nir walks across r*(1+t)/(1-t); water-ish
        # green/swir1 keep mndwi above pswt_1_mndwi so bit 3 tracks ndvi
        r = np.float32(0.03)
        n0 = float(r) * (1 + T.pswt_1_ndvi) / (1 - T.pswt_1_ndvi)
        nir = scan(n0, 0.0, 1.0)
        g = np.full_like(nir, 0.2)
        s1 = np.full_like(nir, 0.01)
        bands = [np.full_like(nir, 0.02), g, np.full_like(nir, r),
                 nir, s1, np.full_like(nir, 0.01)]
        want = REF._compute_diagnostic_tests(*bands, ref_thresholds())
        got = np.asarray(compute_diagnostic_tests(*bands, T))
        np.testing.assert_array_equal(got, want)

        # MNDWI boundaries (negative thresholds): green walks across
        # s1*(1+t)/(1-t) for both pswt thresholds
        for t_mndwi in (T.pswt_1_mndwi, T.pswt_2_mndwi):
            s1v = np.float32(0.12)
            g0 = float(s1v) * (1 + t_mndwi) / (1 - t_mndwi)
            g = scan(g0, 0.0, 1.0)
            bands = [np.full_like(g, 0.02), g, np.full_like(g, 0.9),
                     np.full_like(g, 0.01), np.full_like(g, s1v),
                     np.full_like(g, 0.01)]
            want = REF._compute_diagnostic_tests(*bands, ref_thresholds())
            got = np.asarray(compute_diagnostic_tests(*bands, T))
            np.testing.assert_array_equal(got, want)

    def test_landcover_mask_nondecimal_nir_threshold(self):
        t = T.replace(lcmask_nir=1200 + 1 / 3)
        tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
        ref_t = refbridge.reference_thresholds(tdict)
        shape = (64, 64)
        wtr1 = random_wtr_layer(shape)
        nir = RNG.integers(1195, 1206, shape).astype(np.int16)
        landcover = np.array([0, 99, 123, 199, 200, 201, 255],
                             dtype=np.uint8)[RNG.integers(0, 7, shape)]
        shadow = (RNG.random(shape) < 0.5).astype(np.uint8)
        want = REF._apply_landcover_and_shadow_masks(
            wtr1.copy(), nir, landcover, shadow, ref_t)
        got = np.asarray(masking.apply_landcover_and_shadow_masks(
            wtr1, nir, landcover, shadow, t))
        np.testing.assert_array_equal(got, want)

    def test_interpretation_exhaustive(self):
        diag = np.arange(64, dtype=np.uint16).reshape(8, 8)
        want = REF.generate_interpreted_layer(diag.copy())
        got = np.asarray(generate_interpreted_layer(diag))
        np.testing.assert_array_equal(got, want)

    def test_binary_representation_exhaustive(self):
        diag = np.arange(64, dtype=np.uint16).reshape(8, 8)
        want = REF._get_binary_representation(diag.copy())
        got = np.asarray(get_binary_representation(diag))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize('mode', ['mask', 'cover'])
    def test_preliminary_cloud(self, mode):
        fmask = random_fmask((64, 64))
        want = REF._compute_preliminary_cloud_layer(fmask, mode)
        got = np.asarray(masking.compute_preliminary_cloud_layer(fmask, mode))
        np.testing.assert_array_equal(got, want)

    def test_aerosol_remapping(self):
        cfg = DswxChainConfig()
        shape = (64, 64)
        wtr1 = random_wtr_layer(shape)
        nir = RNG.integers(-2000, 4000, shape).astype(np.int16)
        fmask = random_fmask(shape)
        cloud = REF._compute_preliminary_cloud_layer(fmask, 'mask')
        # make some cloud pixels FILL to exercise the != FILL guard
        cloud[wtr1 == C.UINT8_FILL_VALUE] = C.UINT8_FILL_VALUE

        ref_wtr1, ref_cloud = wtr1.copy(), cloud.copy()
        REF._apply_aerosol_class_remapping(
            ref_wtr1, nir, ref_cloud, fmask,
            list(cfg.aerosol_not_water_fmask_values),
            list(cfg.aerosol_moderate_conf_fmask_values),
            list(cfg.aerosol_psw_conservative_fmask_values),
            list(cfg.aerosol_psw_aggressive_fmask_values))

        got_wtr1, got_cloud = masking.apply_aerosol_class_remapping(
            wtr1, nir, cloud, fmask, cfg.aerosol_lut())
        np.testing.assert_array_equal(np.asarray(got_wtr1), ref_wtr1)
        np.testing.assert_array_equal(np.asarray(got_cloud), ref_cloud)

    @pytest.mark.parametrize('with_landcover,with_shadow', [
        (False, False), (False, True), (True, False), (True, True)])
    def test_landcover_and_shadow_masks(self, with_landcover, with_shadow):
        shape = (64, 64)
        wtr1 = random_wtr_layer(shape)
        nir = RNG.integers(-2000, 4000, shape).astype(np.int16)
        landcover = None
        shadow = None
        if with_landcover:
            vals = np.array([0, 5, 99, 100, 123, 199, 200, 201, 255],
                            dtype=np.uint8)
            landcover = vals[RNG.integers(0, len(vals), size=shape)]
        if with_shadow:
            shadow = (RNG.random(shape) < 0.7).astype(np.uint8)
        want = REF._apply_landcover_and_shadow_masks(
            wtr1.copy(), nir, landcover, shadow, ref_thresholds())
        got = np.asarray(masking.apply_landcover_and_shadow_masks(
            wtr1, nir, landcover, shadow, T))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize('mode', ['mask', 'cover'])
    def test_add_snow_to_cloud(self, mode):
        shape = (96, 96)
        fmask = random_fmask(shape)
        wtr2 = random_wtr_layer(shape)
        cloud = REF._compute_preliminary_cloud_layer(fmask, mode)
        want = REF._add_snow_to_cloud_layer(wtr2.copy(), cloud.copy(),
                                            fmask, mode)
        got = np.asarray(masking.add_snow_to_cloud_layer(
            wtr2, cloud, fmask, mode))
        np.testing.assert_array_equal(got, want)

    def test_cloud_masking_bwtr_conf(self):
        shape = (64, 64)
        fmask = random_fmask(shape)
        wtr2 = random_wtr_layer(shape)
        cloud = REF._add_snow_to_cloud_layer(
            wtr2.copy(), REF._compute_preliminary_cloud_layer(fmask, 'mask'),
            fmask, 'mask')
        want_wtr = REF._apply_cloud_masking(wtr2.copy(), cloud)
        got_wtr = np.asarray(masking.apply_cloud_masking(wtr2, cloud))
        np.testing.assert_array_equal(got_wtr, want_wtr)

        want_bwtr = REF._get_binary_water_layer(want_wtr.copy())
        got_bwtr = np.asarray(get_binary_water_layer(got_wtr))
        np.testing.assert_array_equal(got_bwtr, want_bwtr)

        want_conf = REF._get_confidence_layer(wtr2.copy(), cloud)
        got_conf = np.asarray(get_confidence_layer(wtr2, cloud))
        np.testing.assert_array_equal(got_conf, want_conf)

    def test_collapse(self):
        layer = random_wtr_layer((32, 32))
        want = REF._collapse_wtr_classes(layer.copy())
        got = np.asarray(collapse_wtr_classes(layer))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize('kwargs', [
        dict(),
        dict(exclude_psw_aggressive=True),
        dict(set_not_water_to_nodata=True, set_cloud_to_nodata=True,
             set_snow_to_nodata=True),
        dict(flag_collapse_wtr_classes=False,
             set_ocean_masked_to_nodata=False),
    ])
    def test_browse(self, kwargs):
        wtr = random_wtr_layer((48, 48)).copy()
        wtr[RNG.random((48, 48)) < 0.2] = C.WTR_CLOUD_MASKED
        wtr[RNG.random((48, 48)) < 0.1] = C.WTR_SNOW_MASKED
        want = REF._compute_browse_array(wtr.copy(), **kwargs)
        ours = dict(kwargs)
        if 'flag_collapse_wtr_classes' not in ours:
            ours['flag_collapse_wtr_classes'] = True
        got = np.asarray(compute_browse_array(wtr, **ours))
        np.testing.assert_array_equal(got, want)

    def test_otsu(self):
        image = RNG.normal(0.5, 0.2, (128, 128))
        want = REF._compute_otsu_threshold(image, is_normalized=True)
        got = np.asarray(otsu_binarize(image))
        np.testing.assert_array_equal(got, want)

    def test_otsu_shadow_layer_exact_vs_reference_chain(self):
        """The full otsu shadow branch (dswx_hls.py:4425-4436): exact
        hillshade bytes -> the REFERENCE's own _compute_otsu_threshold
        executing on them -> `hillshade > threshold`. Our byte-LUT cut
        must reproduce the float64 comparison bit-for-bit."""
        import jax.numpy as jnp
        from proteus_jax.models.dswx.shadow import (
            compute_otsu_shadow_layer_exact, _host_hillshade_gdal)
        rng = np.random.default_rng(11)
        for az, elev in [(135.0, 45.0), (277.3, 18.0), (45.0, 70.0)]:
            base = rng.normal(0, 1, (96, 96)).cumsum(0).cumsum(1)
            dem = (base / np.abs(base).max() * 900 + 100).astype(
                np.float32)
            hs = _host_hillshade_gdal(dem, az, elev, 30.0, -30.0)
            want = REF._compute_otsu_threshold(hs, is_normalized=True)
            got = compute_otsu_shadow_layer_exact(
                jnp.asarray(dem), az, elev)
            np.testing.assert_array_equal(np.asarray(got), want)
        # degenerate histogram: constant interior + border-ring zeros
        dem = np.full((48, 48), 512.0, np.float32)
        hs = _host_hillshade_gdal(dem, 135.0, 45.0, 30.0, -30.0)
        want = REF._compute_otsu_threshold(hs, is_normalized=True)
        got = compute_otsu_shadow_layer_exact(jnp.asarray(dem), 135.0,
                                              45.0)
        np.testing.assert_array_equal(np.asarray(got), want)

    def test_decimate_and_update_landcover(self):
        img = RNG.integers(0, 2, (30, 30)).astype(np.uint8)
        want = REF.decimate_by_summation(img, 3, 3)
        got = oracle.decimate_sum(img, 3, 3)
        np.testing.assert_array_equal(got, want)

        conglom = np.full((10, 10), 255, dtype=np.uint8)
        ref_conglom = conglom.copy()
        REF._update_landcover_array(ref_conglom, want, 3, 201)
        conglom[want >= 3] = 201
        np.testing.assert_array_equal(conglom, ref_conglom)

    def test_crop_2d(self):
        arr = RNG.normal(size=(40, 40))
        want = REF._crop_2d_array_all_sides(arr, 5)
        np.testing.assert_array_equal(arr[5:-5, 5:-5], want)


class TestCtableAndMetadataParity:
    """Color tables (dswx_hls.py:1381-1636,2427-2575) and the metadata
    engine (:3817-3972), executed through the functional ColorTable stub."""

    def _compare(self, ref_ct, ours):
        ours_rgba = {k: (v if len(v) == 4 else tuple(v) + (255,))
                     for k, v in ours.items()}
        assert ref_ct.entries == ours_rgba

    @pytest.mark.parametrize('collapse,layer', [
        (True, 'WTR'), (False, 'WTR'), (True, 'WTR-1'), (False, 'WTR-2')])
    def test_interpreted_ctable(self, collapse, layer):
        from proteus_jax.runtime import ctables
        ref_ct = REF._get_interpreted_dswx_ctable(collapse, layer)
        self._compare(ref_ct, ctables.get_interpreted_dswx_ctable(
            collapse, layer))

    @pytest.mark.parametrize('kw', [
        dict(),
        dict(flag_collapse_wtr_classes=False),
        dict(cloud_color='nodata', snow_color='gray'),
        dict(not_water_color='nodata', snow_color='nodata'),
    ])
    def test_browse_ctable(self, kw):
        from proteus_jax.runtime import ctables
        ref_ct = REF._get_browse_ctable(**kw)
        self._compare(ref_ct, ctables.get_browse_ctable(**kw))

    def test_fixed_ctables(self):
        from proteus_jax.runtime import ctables
        self._compare(REF._get_cloud_layer_ctable(),
                      ctables.get_cloud_layer_ctable())
        self._compare(REF._get_landcover_mask_ctable(),
                      ctables.get_landcover_mask_ctable())
        self._compare(REF._get_binary_mask_ctable(),
                      ctables.get_binary_mask_ctable())
        self._compare(REF._get_binary_water_ctable(),
                      ctables.get_binary_water_ctable())
        self._compare(REF._get_confidence_layer_ctable(),
                      ctables.get_confidence_layer_ctable())

    def test_transparency_rgb(self):
        from proteus_jax.runtime import ctables
        for alpha in (0.0, 0.25, 0.5, 0.9, 1.0):
            want = REF.get_transparency_rgb_vals((10, 200, 30),
                                                 (255, 255, 255), alpha)
            got = ctables.get_transparency_rgb_vals((10, 200, 30),
                                                    (255, 255, 255), alpha)
            assert tuple(want) == tuple(got), alpha

    def test_metadata_dict_and_datasets(self):
        from proteus_jax.runtime import metadata as md_util
        want = REF._get_dswx_metadata_dict('OPERA_L3_DSWx', '1.0')
        got = md_util.get_dswx_metadata_dict('OPERA_L3_DSWx', '1.0')
        for k in want:
            if k in ('PROCESSING_DATETIME', 'SOFTWARE_VERSION'):
                continue  # volatile / package-version fields
            assert got[k] == want[k], k
        assert list(got)[:-1] == list(want)[:-1]  # same key order

        for spacecraft, dem_desc in [
                ('SENTINEL-2A', 'Copernicus DEM GLO-30 2021 WGS84'),
                ('LANDSAT-8', None),
                ('SENTINEL-2B', None)]:
            want = REF._get_dswx_metadata_dict('p', 'v')
            got = md_util.get_dswx_metadata_dict('p', 'v')
            want['SPACECRAFT_NAME'] = spacecraft
            got['SPACECRAFT_NAME'] = spacecraft
            kw = dict(dem_file='/a/dem.tif',
                      dem_file_description=dem_desc,
                      landcover_file='/a/lc.tif',
                      shoreline_shapefile=None)
            REF._populate_dswx_metadata_datasets(want, 'HLS.S30.T15RYP',
                                                 **kw)
            md_util.populate_dswx_metadata_datasets(got, 'HLS.S30.T15RYP',
                                                    **kw)
            for k in want:
                if k in ('PROCESSING_DATETIME', 'SOFTWARE_VERSION'):
                    continue
                assert got[k] == want[k], (spacecraft, k)


    @pytest.mark.parametrize('ocean,aerosol,algo', [
        (True, True, 'sun_local_inc_angle'),
        (False, True, 'otsu'),
        (True, False, 'sun_local_inc_angle')])
    def test_metadata_processing_parameters(self, ocean, aerosol, algo):
        from proteus_jax.runtime import metadata as md_util
        kw = dict(
            apply_ocean_masking=ocean,
            apply_aerosol_class_remapping=aerosol,
            aerosol_not_water_to_high_conf_water_fmask_values=[224, 160],
            aerosol_water_moderate_conf_to_high_conf_water_fmask_values=
                [224, 160, 96],
            aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values=
                [224, 192],
            aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values=
                [224],
            shadow_masking_algorithm=algo,
            min_slope_angle=-5.0,
            max_sun_local_inc_angle=40.0,
            mask_adjacent_to_cloud_mode='mask',
            forest_mask_landcover_classes=[20, 50, 111],
            shoreline_shapefile='/a/shore.shp' if ocean else None,
            ocean_masking_shoreline_distance_km=1.0)
        want, got = {}, {}
        REF._populate_dswx_metadata_processing_parameters(want, **kw)
        md_util.populate_dswx_metadata_processing_parameters(got, **kw)
        assert got == dict(want)

    def test_science_constant_dicts(self):
        assert dict(REF.interpreted_dswx_band_dict) == oracle.INTERP
        assert dict(REF.collapse_wtr_classes_dict) == oracle.COLLAPSE
        from proteus_jax.core import constants as C2
        assert dict(REF.band_description_dict) == C2.BAND_DESCRIPTION_DICT


class TestShadowParity:
    """The DEM branch: reference float64 trig chain (dswx_hls.py:4215-4283).

    The production DEM is float32 (Copernicus GLO-30 via cubic warp); under
    NumPy 2 the reference computes the gradient/normal in float32 and the
    arccos/arctan comparisons in float64. compute_opera_shadow_layer_exact
    must be bit-identical, including at and around the decision boundaries.
    """

    def _dem(self, shape=(128, 128), dtype=np.float32, rng=RNG):
        # correlated terrain: smoothed random walk + ridges
        base = rng.normal(0, 1, shape).cumsum(axis=0).cumsum(axis=1)
        base = base / np.abs(base).max() * 800 + 200
        return base.astype(dtype)

    @pytest.mark.parametrize('dtype', [np.float32, np.float64])
    def test_opera_shadow(self, dtype):
        dem = self._dem(dtype=dtype)
        for az, elev, mins, maxi in [(120.0, 45.0, -15.0, 40.0),
                                     (277.3, 18.0, -5.0, 40.0),
                                     (0.0, 85.0, -30.0, 3.0)]:
            want = REF._compute_opera_shadow_layer(dem, az, elev, mins, maxi)
            got = compute_opera_shadow_layer_exact(dem, az, elev, mins, maxi)
            mismatches = int((got.astype(bool) != want).sum())
            assert mismatches == 0, (
                f'{mismatches} boolean flips vs reference float64 chain '
                f'(az={az}, elev={elev})')

    def test_opera_shadow_flat_ties(self):
        # flat DEM puts every pixel exactly at inc == zenith: the worst case
        # for tie-breaking near the threshold
        dem = np.full((32, 32), 351.25, dtype=np.float32)
        for elev, maxi in [(50.0, 40.0), (40.0, 50.0), (45.0, 45.0)]:
            want = REF._compute_opera_shadow_layer(dem, 133.7, elev, -5.0,
                                                   maxi)
            got = compute_opera_shadow_layer_exact(dem, 133.7, elev, -5.0,
                                                   maxi)
            np.testing.assert_array_equal(got.astype(bool), want)

    def _ulp_scan(self, s0, az, elev, mins, maxi, steps=600):
        """Ramp DEMs whose per-column slope walks float32 ULPs around s0,
        driving the decision quantity through the threshold one ULP at a
        time — the regime where a plain f32 chain flips pixels."""
        flips = 0
        s = np.float32(s0)
        for _ in range(steps // 2):
            s = np.nextafter(s, np.float32(-np.inf), dtype=np.float32)
        for _ in range(steps):
            s = np.nextafter(s, np.float32(np.inf), dtype=np.float32)
            dem = (np.arange(16, dtype=np.float32) * s)[None, :].repeat(
                4, axis=0)
            want = REF._compute_opera_shadow_layer(dem, az, elev, mins,
                                                   maxi)
            got = compute_opera_shadow_layer_exact(dem, az, elev, mins,
                                                   maxi).astype(bool)
            flips += int((got != want).sum())
        return flips

    def test_opera_shadow_incidence_boundary_ulp_scan(self):
        az, elev, mins, maxi = 120.0, 45.0, -15.0, 40.0
        x_crit, _ = _decision_boundaries(az, elev, mins, maxi)
        # ramp slope whose incidence angle sits exactly at max_inc: solve
        # (tn*tsv_x + tsv_z)/sqrt(tn^2+1) = x_crit for tn (tn_y = 0)
        tsv_x = np.sin(np.radians(az)) * np.sin(np.radians(90 - elev))
        tsv_z = np.cos(np.radians(90 - elev))
        from scipy.optimize import brentq
        tn = brentq(lambda v: (v * tsv_x + tsv_z) / np.sqrt(v * v + 1)
                    - x_crit, 0, tsv_x / tsv_z)
        assert self._ulp_scan(-tn * 30.0, az, elev, mins, maxi) == 0

    def test_opera_shadow_slope_boundary_ulp_scan(self):
        az, elev, mins, maxi = 120.0, 45.0, -15.0, 40.0
        _, t_crit = _decision_boundaries(az, elev, mins, maxi)
        tn = t_crit / np.sin(np.radians(az))
        assert self._ulp_scan(-tn * 30.0, az, elev, mins, maxi) == 0

    def test_opera_shadow_near_pole_and_fallback(self):
        # sun at zenith + flat DEM: cos(incidence) ~ 1 for every pixel, so
        # the whole tile is inside the uncertainty band; 256^2 > the band
        # budget, forcing the full host-recompute fallback path
        dem = np.full((256, 256), 42.0, dtype=np.float32)
        dem[7, 9] = 43.0  # one bump
        for elev in (89.999, 89.5):
            want = REF._compute_opera_shadow_layer(dem, 10.0, elev, -5.0,
                                                   0.0005)
            got = compute_opera_shadow_layer_exact(dem, 10.0, elev, -5.0,
                                                   0.0005)
            np.testing.assert_array_equal(got.astype(bool), want)

    def test_opera_shadow_as_device_matches_host(self):
        # the device-resident variant (epsilon band patched by scatter)
        # must equal the host-returned mask, including patched pixels
        az, elev, mins, maxi = 120.0, 45.0, -15.0, 40.0
        _, t_crit = _decision_boundaries(az, elev, mins, maxi)
        tn = t_crit / np.sin(np.radians(az))
        s = np.float32(-tn * 30.0)  # slope pinned at the decision boundary
        dem = (np.arange(64, dtype=np.float32) * s)[None, :].repeat(
            16, axis=0)
        host = compute_opera_shadow_layer_exact(dem, az, elev, mins, maxi)
        dev = compute_opera_shadow_layer_exact(dem, az, elev, mins, maxi,
                                               as_device=True)
        np.testing.assert_array_equal(np.asarray(dev), host)
        want = REF._compute_opera_shadow_layer(dem, az, elev, mins, maxi)
        np.testing.assert_array_equal(np.asarray(dev).astype(bool), want)

    def test_opera_shadow_nan_dem(self):
        dem = self._dem((64, 64))
        dem[10:20, 30:40] = np.nan
        want = REF._compute_opera_shadow_layer(dem, 120.0, 45.0, -15.0, 40.0)
        got = compute_opera_shadow_layer_exact(dem, 120.0, 45.0, -15.0, 40.0)
        np.testing.assert_array_equal(got.astype(bool), want)

    def test_opera_shadow_sentinel_cliffs(self):
        """Huge terrain normals (|tn| ~ 300): a -9999 fill sentinel next
        to 8000 m peaks. The device f32 error of the directional-slope
        dot product scales with |tn|, so the uncertainty band must widen
        per pixel or near-threshold decisions silently flip."""
        rng = np.random.default_rng(97)
        for seed in range(8):
            r = np.random.default_rng(seed)
            dem = r.choice(np.array([-9999.0, 8000.0, 7990.0, 150.0, 0.0],
                                    np.float32), (96, 96)).astype(
                np.float32)
            az = float(r.uniform(0, 360))
            elev = float(r.uniform(1, 89))
            mins = float(r.uniform(-45, 0))
            maxi = float(r.uniform(1, 89))
            want = REF._compute_opera_shadow_layer(dem, az, elev, mins,
                                                   maxi)
            got = compute_opera_shadow_layer_exact(dem, az, elev, mins,
                                                   maxi)
            np.testing.assert_array_equal(
                got.astype(bool), want,
                err_msg=f'seed={seed} az={az} elev={elev}')
        del rng


class TestFullChainParity:
    """Orchestrator stage ordering vs the reference (dswx_hls.py:5225-5368),
    composed from the reference's own functions."""

    def _reference_chain(self, bands, fmask, invalid, mode, cfg,
                         ocean=None, shadow=None, landcover=None):
        diag_dec = REF._compute_diagnostic_tests(*bands, ref_thresholds())
        diag_dec[invalid] = C.DIAGNOSTIC_LAYER_NO_DATA_DECIMAL
        wtr1 = REF.generate_interpreted_layer(diag_dec)
        diag = REF._get_binary_representation(diag_dec)
        if ocean is not None:
            wtr1[ocean == 0] = C.WTR_OCEAN_MASKED
        wtr1[invalid] = C.UINT8_FILL_VALUE
        wtr1_product = wtr1.copy()
        cloud = REF._compute_preliminary_cloud_layer(fmask, mode)
        REF._apply_aerosol_class_remapping(
            wtr1, bands[3], cloud, fmask,
            list(cfg.aerosol_not_water_fmask_values),
            list(cfg.aerosol_moderate_conf_fmask_values),
            list(cfg.aerosol_psw_conservative_fmask_values),
            list(cfg.aerosol_psw_aggressive_fmask_values))
        wtr2 = REF._apply_landcover_and_shadow_masks(
            wtr1, bands[3], landcover, shadow, ref_thresholds())
        cloud = REF._add_snow_to_cloud_layer(wtr2, cloud, fmask, mode)
        wtr = REF._apply_cloud_masking(wtr2, cloud)
        bwtr = REF._get_binary_water_layer(wtr)
        conf = REF._get_confidence_layer(wtr2, cloud)
        return {'DIAG': diag, 'WTR-1': wtr1_product, 'WTR-2': wtr2,
                'WTR': wtr, 'BWTR': bwtr, 'CONF': conf, 'CLOUD': cloud}

    @pytest.mark.parametrize('mode', ['mask', 'cover'])
    def test_full_chain(self, mode):
        shape = (160, 160)
        bands = random_bands(shape)
        bands = [np.clip(b, 1, None) for b in bands]
        fmask = random_fmask(shape)
        invalid = RNG.random(shape) < 0.05
        ocean = (RNG.random(shape) < 0.9).astype(np.uint8)
        shadow = (RNG.random(shape) < 0.8).astype(np.uint8)
        lc_vals = np.array([0, 99, 100, 199, 200, 201, 255], dtype=np.uint8)
        landcover = lc_vals[RNG.integers(0, len(lc_vals), size=shape)]

        cfg = DswxChainConfig(thresholds=T, mask_adjacent_to_cloud_mode=mode)
        want = self._reference_chain(bands, fmask, invalid, mode, cfg,
                                     ocean=ocean, shadow=shadow,
                                     landcover=landcover)
        got = dswx_chain(*bands, fmask, invalid, cfg, ocean_mask=ocean,
                         shadow_layer=shadow, landcover_mask=landcover,
                         compute_browse=False)
        for layer in want:
            np.testing.assert_array_equal(
                np.asarray(got[layer]), want[layer],
                err_msg=f'layer {layer} (mode={mode})')

    def test_oracle_itself_matches_reference(self):
        """Certify tests/oracle.py (used by the 1000-iter fuzz) against the
        reference's executing code, so fuzz coverage transfers."""
        shape = (128, 128)
        for mode in ('mask', 'cover'):
            for _ in range(5):
                bands = random_bands(shape)
                bands = [np.clip(b, 1, None) for b in bands]
                fmask = random_fmask(shape)
                invalid = RNG.random(shape) < 0.05
                shadow = (RNG.random(shape) < 0.8).astype(np.uint8)
                cfg = DswxChainConfig(thresholds=T,
                                      mask_adjacent_to_cloud_mode=mode)
                want = self._reference_chain(bands, fmask, invalid, mode,
                                             cfg, shadow=shadow)
                lists = {0: list(cfg.aerosol_not_water_fmask_values),
                         2: list(cfg.aerosol_moderate_conf_fmask_values),
                         3: list(cfg.aerosol_psw_conservative_fmask_values),
                         4: list(cfg.aerosol_psw_aggressive_fmask_values)}
                got = oracle.full_chain(*bands, fmask, invalid, TDICT,
                                        mode=mode, aerosol_lists=lists,
                                        shadow=shadow)
                for layer in want:
                    np.testing.assert_array_equal(
                        got[layer], want[layer],
                        err_msg=f'oracle layer {layer} (mode={mode})')
