"""Geo engine tests: CRS round-trips, MGRS, warp parity (host/device/
exact), antimeridian wrap, ocean mask, coverage checks."""

import numpy as np
import pytest

from proteus_jax.geo.crs import (CRS, transform_points, utm_forward,
                                 utm_inverse)
from proteus_jax.geo.mgrs import (get_hls_geographic_boundaries_from_mgrs_tile,
                                  mgrs_to_utm, mgrs_tile_geotransform)
from proteus_jax.geo.warp import warp_to_grid, warp_to_grid_device
from proteus_jax.io.cog import write_cog

RNG = np.random.default_rng(5)


class TestCRS:
    def test_utm_roundtrip(self):
        lat = RNG.uniform(-79, 83, 5000)
        lon = RNG.uniform(-60, 60, 5000)
        x, y = utm_forward(lat, lon, 31, True)
        la, lo = utm_inverse(x, y, 31, True)
        assert np.abs(la - lat).max() < 1e-9
        assert np.abs(lo - lon).max() < 1e-9

    def test_central_meridian_anchor(self):
        x, y = utm_forward(0.0, 3.0, 31, True)
        assert float(x) == pytest.approx(500000.0, abs=1e-6)
        assert float(y) == pytest.approx(0.0, abs=1e-6)

    def test_southern_hemisphere(self):
        x, y = utm_forward(-33.8568, 151.2153, 56, False)
        assert 250000 < float(x) < 400000
        assert 6200000 < float(y) < 6300000  # false northing applied

    def test_wkt_proj4_roundtrip(self):
        for epsg in (32601, 32660, 32701, 4326):
            crs = CRS.from_epsg(epsg)
            assert CRS.from_wkt(crs.to_wkt()).epsg == epsg
            assert CRS.from_proj4(crs.to_proj4()).epsg == epsg

    def test_transform_points_identity(self):
        x, y = transform_points(32615, 32615, [1.0, 2.0], [3.0, 4.0])
        np.testing.assert_array_equal(x, [1.0, 2.0])


class TestMGRS:
    def test_louisiana_tile(self):
        # the reference workflow-test tile
        assert mgrs_to_utm('T15RYP') == (15, True, 700000.0, 3300000.0)
        lat_min, lat_max, lon_min, lon_max = \
            get_hls_geographic_boundaries_from_mgrs_tile('T15RYP')
        assert 29.5 < lat_min < 30.0 and 30.5 < lat_max < 31.0
        assert -91.2 < lon_min < -90.7 and -90.0 < lon_max < -89.6

    def test_product_grid(self):
        gt, epsg, length, width = mgrs_tile_geotransform('T15RYP')
        assert (length, width) == (3660, 3660)
        assert epsg == 32615
        assert gt[0] == 700000.0 - 4900.0
        assert gt[3] == 3300000.0 - 4900.0 + 109800.0

    def test_invalid_names(self):
        for bad in ('XX', '99ZAA', '15IYP', 'T15RYPZ'):
            with pytest.raises(ValueError):
                mgrs_to_utm(bad)


@pytest.fixture(scope='module')
def latlon_source(tmp_path_factory):
    """EPSG:4326 raster whose value encodes its own pixel position."""
    root = tmp_path_factory.mktemp('warpsrc')
    h, w = 700, 900
    # cover the UTM 15N test tile (lon -91.2..-89.6, lat 29.5..31)
    gt = (-92.0, 0.004, 0.0, 31.5, 0.0, -0.004)
    arr = (np.arange(h)[:, None] * 1000
           + np.arange(w)[None, :]).astype(np.int32).astype(np.float32)
    path = str(root / 'src.tif')
    write_cog(path, arr, geotransform=gt, epsg=4326, overview_levels=())
    return path, gt, arr


class TestWarp:
    def test_nearest_against_direct_math(self, latlon_source):
        path, gt, arr = latlon_source
        tile_gt = (700000.0, 30.0, 0.0, 3395100.0, 0.0, -30.0)
        out = warp_to_grid(path, tile_gt, 'EPSG:32615', 200, 200)
        # direct check at a few pixels: inverse-project the pixel center,
        # find the nearest source pixel, compare the encoded value
        from proteus_jax.geo.crs import utm_inverse
        for (i, j) in [(0, 0), (50, 120), (199, 199), (123, 7)]:
            x = tile_gt[0] + (j + 0.5) * 30.0
            y = tile_gt[3] - (i + 0.5) * 30.0
            lat, lon = utm_inverse(x, y, 15, True)
            sc = int(np.floor((lon - gt[0]) / gt[1]))
            sr = int(np.floor((gt[3] - lat) / -gt[5]))
            assert out[i, j] == arr[sr, sc], (i, j)

    def test_grid_transformer_matches_exact(self, latlon_source):
        path, gt, arr = latlon_source
        tile_gt = (700000.0, 30.0, 0.0, 3395100.0, 0.0, -30.0)
        a = warp_to_grid(path, tile_gt, 'EPSG:32615', 150, 150,
                         transformer='grid')
        b = warp_to_grid(path, tile_gt, 'EPSG:32615', 150, 150,
                         transformer='exact')
        assert (a != b).mean() < 1e-3  # razor-edge nearest picks only

    def test_device_warp_matches_host(self, latlon_source):
        path, gt, arr = latlon_source
        tile_gt = (700000.0, 30.0, 0.0, 3395100.0, 0.0, -30.0)
        for alg in ('nearest', 'cubic', 'bilinear'):
            host = warp_to_grid(path, tile_gt, 'EPSG:32615', 150, 150,
                                resample_algorithm=alg)
            dev = np.asarray(warp_to_grid_device(
                path, tile_gt, 'EPSG:32615', 150, 150,
                resample_algorithm=alg))
            # dd-f32 coordinates/accumulation + host boundary resolve:
            # bit-equal for every resampler
            np.testing.assert_array_equal(host, dev, err_msg=alg)

    def test_device_cubic_nodata_matches_host(self, tmp_path):
        """Masked cubic (NaN holes -> renormalizing accumulation +
        dd division correction) must be bit-identical to the host
        float64 path too."""
        h, w = 300, 300
        gt = (-91.5, 0.004, 0.0, 31.0, 0.0, -0.004)
        arr = (120 * np.sin(np.arange(w)[None, :] / 17.0)
               * np.cos(np.arange(h)[:, None] / 13.0)
               + RNG.normal(0, 20, (h, w))).astype(np.float32)
        arr[100:130, 100:140] = np.nan
        arr[RNG.random((h, w)) < 0.01] = np.nan
        path = str(tmp_path / 'dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=4326,
                  nodata=float('nan'), overview_levels=())
        tile_gt = (700000.0, 30.0, 0.0, 3390000.0, 0.0, -30.0)
        host = warp_to_grid(path, tile_gt, 'EPSG:32615', 150, 150,
                            resample_algorithm='cubic',
                            margin_in_pixels=10)
        dev = np.asarray(warp_to_grid_device(
            path, tile_gt, 'EPSG:32615', 150, 150,
            resample_algorithm='cubic', margin_in_pixels=10))
        both_nan = np.isnan(host) & np.isnan(dev)
        np.testing.assert_array_equal(host[~both_nan], dev[~both_nan])

    def test_warp_fuzz_pinned_seeds(self, tmp_path):
        """Regression pins for device-vs-host escapes the long fuzz
        found: 7114 hit dd_floor's f32-rounded fraction wrap (coordinate
        ~2^-25 below an integer on a wrapping source); 7012 hit the
        host-resolver out-of-pad indexing; 7000 the rint boundary of a
        narrowing int dtype."""
        import fuzz_chain
        for seed in (7000, 7012, 7114):
            fuzz_chain.one_warp_iteration(seed, str(tmp_path))

    def test_device_nearest_boundary_resolve(self, tmp_path):
        """Same-CRS warp with a half-pixel origin shift puts EVERY
        output coordinate exactly on a pick boundary — the worst case
        for the ambiguity band. The device result must still be
        bit-identical to the host float64 decisions."""
        h, w = 120, 120
        gt = (700000.0, 30.0, 0.0, 3395100.0, 0.0, -30.0)
        arr = RNG.integers(0, 200, (h, w)).astype(np.uint8)
        path = str(tmp_path / 'src.tif')
        write_cog(path, arr, geotransform=gt, epsg=32615, nodata=255,
                  overview_levels=())
        # origin shifted by half a source pixel: u = j exactly
        tile_gt = (700000.0 - 15.0, 30.0, 0.0, 3395100.0 + 15.0,
                   0.0, -30.0)
        host = warp_to_grid(path, tile_gt, 'EPSG:32615', 100, 100,
                            resample_algorithm='nearest')
        dev = np.asarray(warp_to_grid_device(
            path, tile_gt, 'EPSG:32615', 100, 100,
            resample_algorithm='nearest'))
        np.testing.assert_array_equal(host, dev)

    def test_cubic_margin_and_nodata(self, tmp_path):
        h, w = 300, 300
        gt = (-91.5, 0.004, 0.0, 31.0, 0.0, -0.004)
        arr = RNG.normal(500, 100, (h, w)).astype(np.float32)
        arr[100:120, 100:120] = -9999.0
        path = str(tmp_path / 'dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=4326, nodata=-9999,
                  overview_levels=())
        tile_gt = (700000.0, 30.0, 0.0, 3390000.0, 0.0, -30.0)
        out = warp_to_grid(path, tile_gt, 'EPSG:32615', 100, 100,
                           resample_algorithm='cubic',
                           margin_in_pixels=10)
        assert out.shape == (120, 120)
        # values stay in a sane range (renormalized kernels, no nodata
        # bleed-through into valid areas)
        valid = out != -9999.0
        assert valid.any()
        assert np.abs(out[valid] - 500).max() < 500

    def test_antimeridian_wrap(self, tmp_path):
        """A global [-180,180] source warped onto a tile crossing +180
        must be seamless (the reference needs a two-sided crop+warp)."""
        h, w = 300, 1800  # 0.2 deg/px global in lon
        gt = (-180.0, 0.2, 0.0, 80.0, 0.0, -0.2)
        arr = np.tile((np.arange(w) % 256).astype(np.uint8), (h, 1))
        path = str(tmp_path / 'global.tif')
        write_cog(path, arr, geotransform=gt, epsg=4326,
                  overview_levels=())
        # UTM zone 1 tile whose west margin crosses the antimeridian
        tile_gt = (199980.0, 30.0, 0.0, 7000000.0, 0.0, -30.0)
        out = warp_to_grid(path, tile_gt, 'EPSG:32601', 200, 200)
        # no fill stripe: every output pixel found a source pixel
        assert (out != 0).all() or (out == 0).mean() < 0.05
        for alg in ('nearest', 'bilinear', 'cubic'):
            host = warp_to_grid(path, tile_gt, 'EPSG:32601', 200, 200,
                                resample_algorithm=alg)
            dev = np.asarray(warp_to_grid_device(
                path, tile_gt, 'EPSG:32601', 200, 200,
                resample_algorithm=alg))
            np.testing.assert_array_equal(host, dev, err_msg=alg)


class TestOceanMask:
    def test_land_side_and_margin(self, tmp_path):
        import synthetic
        from proteus_jax.geo.polygon import create_ocean_mask
        size = 200
        shore = synthetic.make_shoreline(str(tmp_path), size=size)
        gt = synthetic.geotransform()
        mask = create_ocean_mask(shore, 1.0, str(tmp_path), gt,
                                 'EPSG:32615', size, size)
        # west side land (1), east side ocean (0)
        assert mask[:, : int(size * 0.5)].all()
        assert (mask[:, -int(size * 0.2):] == 0).mean() > 0.9
        # a larger margin pushes the boundary further into the ocean
        mask3 = create_ocean_mask(shore, 3.0, str(tmp_path), gt,
                                  'EPSG:32615', size, size)
        assert mask3.sum() > mask.sum()


class TestCoverage:
    def test_full_and_missing(self, tmp_path):
        import synthetic
        from proteus_jax.geo.coverage import check_ancillary_inputs
        size = 64
        dem = synthetic.make_dem(str(tmp_path), size=size)
        lc = synthetic.make_landcover(str(tmp_path), size=size)
        wc = synthetic.make_worldcover(str(tmp_path), size=size)
        md = {}
        check_ancillary_inputs(True, False, dem, lc, wc, None,
                               synthetic.geotransform(), 'EPSG:32615',
                               size, size, md)
        assert md['DEM_COVERAGE'] == 'FULL'
        assert md['LANDCOVER_COVERAGE'] == 'FULL'
        assert md['WORLDCOVER_COVERAGE'] == 'FULL'
        with pytest.raises(ValueError):
            check_ancillary_inputs(True, False, None, lc, wc, None,
                                   synthetic.geotransform(),
                                   'EPSG:32615', size, size, {})
        with pytest.raises(FileNotFoundError):
            check_ancillary_inputs(True, False, '/no/such.tif', lc, wc,
                                   None, synthetic.geotransform(),
                                   'EPSG:32615', size, size, {})

    def test_partial_coverage_error(self, tmp_path):
        """A DEM that misses part of the tile must raise."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        import synthetic
        h = w = 50
        gt = (-90.9, 0.004, 0.0, 30.6, 0.0, -0.004)  # covers a corner only
        arr = np.zeros((h, w), np.float32)
        dem = str(tmp_path / 'partial_dem.tif')
        write_cog(dem, arr, geotransform=gt, epsg=4326,
                  overview_levels=())
        with pytest.raises(ValueError):
            check_ancillary_inputs(True, False, dem, dem, dem, None,
                                   synthetic.geotransform(),
                                   'EPSG:32615', 360, 360, {})


class TestPolarStereographic:
    def test_epsg_guidance_note_example(self):
        """EPSG Guidance Note 7-2 worked example for Polar Stereographic
        variant B (EPSG:3032): 75S 120E -> E 7255380.79 N 7053389.56."""
        from proteus_jax.geo.crs import (polar_stereo_forward,
                                         polar_stereo_inverse)
        E, N = polar_stereo_forward(-75.0, 120.0, -71.0, 70.0, 6e6, 6e6,
                                    False)
        assert abs(E - 7255380.79) < 0.01
        assert abs(N - 7053389.56) < 0.01
        lat, lon = polar_stereo_inverse(7255380.79, 7053389.56, -71.0,
                                        70.0, 6e6, 6e6, False)
        assert abs(lat - -75.0) < 1e-7 and abs(lon - 120.0) < 1e-7

    @pytest.mark.parametrize('epsg', [3031, 3413, 3976])
    def test_roundtrip_and_unit_scale(self, epsg):
        from proteus_jax.geo.crs import (CRS, polar_stereo_forward,
                                         polar_stereo_inverse)
        ps = CRS.from_epsg(epsg).polar_stereo
        rng = np.random.default_rng(epsg)
        sign = 1 if ps[4] else -1
        lat = sign * rng.uniform(55, 89.99, 5000)
        lon = rng.uniform(-180, 180, 5000)
        x, y = polar_stereo_forward(lat, lon, *ps)
        la2, lo2 = polar_stereo_inverse(x, y, *ps)
        assert np.abs(la2 - lat).max() < 1e-12
        assert np.abs((lo2 - lon + 180) % 360 - 180).max() < 1e-12
        # variant B: scale factor 1 at the standard parallel
        x1, y1 = polar_stereo_forward(ps[0], 0.0, *ps)
        x2, y2 = polar_stereo_forward(ps[0], 1e-3, *ps)
        latr = np.radians(abs(ps[0]))
        nu = 6378137.0 / np.sqrt(
            1 - 0.00669437999014132 * np.sin(latr) ** 2)
        d_true = np.radians(1e-3) * nu * np.cos(latr)
        k = np.hypot(x2 - x1, y2 - y1) / d_true
        assert abs(k - 1.0) < 1e-9

    def test_ps_warp_device_matches_host(self, tmp_path):
        """A DEM delivered in EPSG:3031 warped onto a southern UTM tile:
        grid-transformer warp vs exact per-pixel transform, and device
        vs host bit-equality."""
        rng = np.random.default_rng(3)
        h = w = 300
        # 1 km PS grid around (0E, ~70S): PS coords near (0, 2.2e6)
        gt = (-150000.0, 1000.0, 0.0, 2400000.0, 0.0, -1000.0)
        arr = (1000 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        path = str(tmp_path / 'ps_dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=3031,
                  nodata=float('nan'), overview_levels=())
        # UTM 31S tile near 69.5S (PS y ~ 2.27e6 at lon ~3E)
        tile_gt = (500000.0, 30.0, 0.0, 2290000.0 + 10000000.0 - 7.72e6,
                   0.0, -30.0)
        tile_gt = (460000.0, 30.0, 0.0, 2286000.0, 0.0, -30.0)
        proj = 'EPSG:32731'
        from proteus_jax.geo.crs import transform_points
        # confirm the tile's center actually lands inside the PS source
        cx, cy = transform_points(proj, 'EPSG:3031',
                                  np.array([462000.0]),
                                  np.array([2284000.0]))
        assert -150000 < cx[0] < 150000 and 2.1e6 < cy[0] < 2.4e6
        for alg in ('nearest', 'bilinear', 'cubic'):
            host = warp_to_grid(path, tile_gt, proj, 100, 120,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            exact = warp_to_grid(path, tile_gt, proj, 100, 120,
                                 resample_algorithm=alg,
                                 margin_in_pixels=10,
                                 transformer='exact')
            nn = np.isnan(host)
            finite = ~nn
            # grid-vs-exact transformer: identical picks away from the
            # 5 mm interpolation band (nearest may flip a boundary pick)
            close = np.isclose(host, exact, rtol=1e-5, atol=1e-3,
                               equal_nan=True)
            assert close.mean() > 0.999
            dev = np.asarray(warp_to_grid_device(
                path, tile_gt, proj, 100, 120, resample_algorithm=alg,
                margin_in_pixels=10))
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), f'{alg}: {bad.sum()} mismatches'
            assert finite.any(), 'tile missed the PS source entirely'

    def test_unsupported_crs_rejected_at_coverage_check(self, tmp_path):
        """A non-4326/UTM/PS ancillary must fail inside
        check_ancillary_inputs with a clear message, not mid-warp."""
        import synthetic
        from proteus_jax.geo.coverage import check_ancillary_inputs
        size = 64
        dem = synthetic.make_dem(str(tmp_path), size=size)
        arr = np.zeros((50, 50), np.float32)
        # ESRI:54009 Mollweide: a projection family the engine does
        # not implement (3857 web-mercator became supported in round 3)
        weird = str(tmp_path / 'mollweide.tif')
        write_cog(weird, arr, geotransform=(0, 100, 0, 0, 0, -100),
                  epsg=54009, overview_levels=())
        with pytest.raises(ValueError, match='unsupported CRS'):
            check_ancillary_inputs(True, False, weird, dem, dem, None,
                                   synthetic.geotransform(),
                                   'EPSG:32615', size, size, {})


class TestWidenedCrs:
    """NAD83/ETRS89 UTM (GRS80) + UPS variant A (round-3 widening;
    reference accepts any OSR SRS, dswx_hls.py:3385-3461)."""

    def test_nad83_utm_agrees_with_wgs84_utm(self):
        from proteus_jax.geo.crs import transform_points
        lon = np.linspace(-95.9, -90.1, 200)
        lat = np.linspace(25.0, 49.0, 200)
        x83, y83 = transform_points(4269, 26915, lon, lat)
        x84, y84 = transform_points(4326, 32615, lon, lat)
        # GRS80 and WGS84 differ only in 1/f at the 1e-9 level: the
        # projected difference is micrometers (null datum shift)
        assert np.abs(x83 - x84).max() < 1e-3
        assert np.abs(y83 - y84).max() < 1e-3

    @pytest.mark.parametrize('epsg,lon_range,lat_range', [
        (26915, (-96, -90), (25, 60)),    # NAD83 / UTM 15N
        (25832, (6, 12), (36, 70)),       # ETRS89 / UTM 32N
    ])
    def test_grs80_utm_roundtrip(self, epsg, lon_range, lat_range):
        from proteus_jax.geo.crs import CRS, utm_forward, utm_inverse
        crs = CRS.from_epsg(epsg)
        assert crs.supported and crs.ellipsoid == 'GRS80'
        rng = np.random.default_rng(epsg)
        lat = rng.uniform(*lat_range, 5000)
        lon = rng.uniform(*lon_range, 5000)
        x, y = utm_forward(lat, lon, *crs.utm, ell='GRS80')
        la2, lo2 = utm_inverse(x, y, *crs.utm, ell='GRS80')
        assert np.abs(la2 - lat).max() < 1e-11
        assert np.abs(lo2 - lon).max() < 1e-11

    def test_ups_epsg_guidance_note_example(self):
        """EPSG Guidance Note 7-2 worked example for Polar Stereographic
        variant A (WGS 84 / UPS North, EPSG:5041):
        73N 44E -> E 3320416.75 N 632668.43."""
        from proteus_jax.geo.crs import (CRS, polar_stereo_forward,
                                         polar_stereo_inverse)
        ps = CRS.from_epsg(5041).polar_stereo
        E, N = polar_stereo_forward(73.0, 44.0, *ps)
        assert abs(E - 3320416.75) < 0.01
        assert abs(N - 632668.43) < 0.01
        lat, lon = polar_stereo_inverse(3320416.75, 632668.43, *ps)
        assert abs(lat - 73.0) < 1e-7 and abs(lon - 44.0) < 1e-7

    @pytest.mark.parametrize('epsg', [5041, 5042])
    def test_ups_roundtrip_and_scale(self, epsg):
        from proteus_jax.geo.crs import (CRS, polar_stereo_forward,
                                         polar_stereo_inverse)
        ps = CRS.from_epsg(epsg).polar_stereo
        assert len(ps) == 6 and ps[5] == 0.994
        rng = np.random.default_rng(epsg)
        sign = 1 if ps[4] else -1
        lat = sign * rng.uniform(60, 89.99, 5000)
        lon = rng.uniform(-180, 180, 5000)
        x, y = polar_stereo_forward(lat, lon, *ps)
        la2, lo2 = polar_stereo_inverse(x, y, *ps)
        assert np.abs(la2 - lat).max() < 1e-11
        assert np.abs((lo2 - lon + 180) % 360 - 180).max() < 1e-11
        # variant A: unit scale at the implied standard parallel
        # 81 deg 06 min 52.3 sec (the published UPS equivalence for
        # k0 = 0.994)
        lat_ts = sign * (81 + 6 / 60 + 52.3 / 3600)
        x1, y1 = polar_stereo_forward(lat_ts, 0.0, *ps)
        x2, y2 = polar_stereo_forward(lat_ts, 1e-3, *ps)
        latr = np.radians(abs(lat_ts))
        nu = 6378137.0 / np.sqrt(
            1 - 0.00669437999014132 * np.sin(latr) ** 2)
        d_true = np.radians(1e-3) * nu * np.cos(latr)
        k = np.hypot(x2 - x1, y2 - y1) / d_true
        assert abs(k - 1.0) < 1e-6

    @pytest.mark.parametrize('epsg', [26915, 25832, 5041, 5042, 4269,
                                      4258])
    def test_wkt_proj4_roundtrip(self, epsg):
        from proteus_jax.geo.crs import CRS
        crs = CRS.from_epsg(epsg)
        assert CRS.from_wkt(crs.to_wkt()).epsg == epsg
        assert CRS.from_proj4(crs.to_proj4()).epsg == epsg
        # authority-free WKT falls back to name/datum parsing
        import re as _re
        no_auth = _re.sub(r',?AUTHORITY\[[^\]]*\]', '', crs.to_wkt())
        assert CRS.from_wkt(no_auth).epsg == epsg

    def test_nad83_dem_warp_device_matches_host(self, tmp_path):
        """A DEM delivered in NAD83 UTM (EPSG:26915) warped onto a
        WGS84 UTM 15N tile: accepted by the coverage check, and device
        warp bit-identical to host."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        rng = np.random.default_rng(9)
        h = w = 300
        gt = (580000.0, 60.0, 0.0, 3310000.0, 0.0, -60.0)
        arr = (500 + 100 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        path = str(tmp_path / 'nad83_dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=26915,
                  nodata=float('nan'), overview_levels=())
        tile_gt = (584000.0, 30.0, 0.0, 3306000.0, 0.0, -30.0)
        proj = 'EPSG:32615'
        check_ancillary_inputs(True, False, path, path, path, None,
                               tile_gt, proj, 100, 120, {})
        for alg in ('nearest', 'bilinear', 'cubic'):
            host = warp_to_grid(path, tile_gt, proj, 100, 120,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            nn = np.isnan(host)
            assert (~nn).any(), 'tile missed the NAD83 source'
            dev = np.asarray(warp_to_grid_device(
                path, tile_gt, proj, 100, 120, resample_algorithm=alg,
                margin_in_pixels=10))
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), f'{alg}: {bad.sum()} mismatches'


class TestEqualAreaCrs:
    """Albers Conic + Lambert Azimuthal Equal Area grids (round-3
    widening): the national land-product CRSs an ancillary DEM or
    landcover plausibly ships in (NLCD 5070, Australian Albers 3577,
    ETRS89-LAEA 3035, EASE-Grid 2.0 6931/6932). Reference accepts them
    through OSR, dswx_hls.py:3385-3461."""

    def test_laea_epsg_guidance_note_example(self):
        """EPSG Guidance Note 7-2 worked example (ETRS89 / LAEA Europe):
        50N 5E -> E 3962799.45, N 2999718.85."""
        from proteus_jax.geo.crs import (CRS, laea_forward, laea_inverse)
        p = CRS.from_epsg(3035).laea
        E, N = laea_forward(50.0, 5.0, *p)
        assert abs(E - 3962799.45) < 0.01
        assert abs(N - 2999718.85) < 0.01
        lat, lon = laea_inverse(3962799.45, 2999718.85, *p)
        assert abs(lat - 50.0) < 1e-7 and abs(lon - 5.0) < 1e-7

    def test_albers_snyder_numerical_example(self):
        """Snyder 1987 Appendix numerical example for the ellipsoidal
        Albers (Clarke 1866, sp 29.5/45.5, origin 23N 96W): 35N 75W ->
        x 1885472.7, y 1535925.0 (published to 0.1 m)."""
        from proteus_jax.geo import crs
        crs._ELLIPSOIDS.setdefault(
            'CLARKE1866', (6378206.4, 294.9786982139006))
        x, y = crs.albers_forward(35.0, -75.0, 'CLARKE1866',
                                  23.0, -96.0, 29.5, 45.5, 0.0, 0.0)
        assert abs(x - 1885472.7) < 0.5
        assert abs(y - 1535925.0) < 0.5

    _DOMAINS = {5070: (25, 49, -124, -66), 3577: (-44, -10, 112, 154),
                3035: (35, 70, -10, 30), 6931: (30, 89.9, -180, 180),
                6932: (-89.9, -30, -180, 180)}

    @pytest.mark.parametrize('epsg', [5070, 3577, 3035, 6931, 6932])
    def test_roundtrip_via_transform_points(self, epsg):
        rng = np.random.default_rng(epsg)
        la, lb, lo, hi = self._DOMAINS[epsg]
        lat = rng.uniform(la, lb, 500)
        lon = rng.uniform(lo, hi, 500)
        x, y = transform_points('EPSG:4326', f'EPSG:{epsg}', lon, lat)
        lon2, lat2 = transform_points(f'EPSG:{epsg}', 'EPSG:4326', x, y)
        assert np.abs(lat2 - lat).max() < 1e-8
        dlon = (np.abs(lon2 - lon) + 180.0) % 360.0 - 180.0
        assert np.abs(dlon).max() < 1e-8

    def test_albers_unit_scale_at_standard_parallels(self):
        """k = 1 along both standard parallels (the defining property
        of the secant conic; pins n and C)."""
        from proteus_jax.geo.crs import CRS, albers_forward
        for epsg in (5070, 3577):
            p = CRS.from_epsg(epsg).albers
            ell, lat0, lon0, sp1, sp2 = p[:5]
            from proteus_jax.geo.crs import _ell_consts
            a, e2, _ = _ell_consts(ell)
            for sp in (sp1, sp2):
                x1, y1 = albers_forward(sp, lon0, *p)
                x2, y2 = albers_forward(sp, lon0 + 1e-3, *p)
                latr = np.radians(sp)
                d_true = (np.radians(1e-3) * a * np.cos(latr)
                          / np.sqrt(1 - e2 * np.sin(latr) ** 2))
                k = np.hypot(x2 - x1, y2 - y1) / d_true
                assert abs(k - 1.0) < 1e-6, (epsg, sp)

    @pytest.mark.parametrize('epsg', [5070, 3577, 3035, 6931, 6932])
    def test_equal_area_jacobian(self, epsg):
        """|det d(x,y)/d(lon,lat)| == a^2 (1-e2) cos(lat) /
        (1-e2 sin^2 lat)^2 everywhere — the equal-area property, an
        implementation check independent of any published vector."""
        from proteus_jax.geo.crs import CRS, _ell_consts, transform_points
        rng = np.random.default_rng(7 * epsg)
        la, lb, lo, hi = self._DOMAINS[epsg]
        lat = rng.uniform(la + 0.1, lb - 0.1, 200)
        lon = rng.uniform(lo + 0.1, hi - 0.1, 200)
        crs = CRS.from_epsg(epsg)
        ell = (crs.albers or crs.laea)[0]
        a, e2, _ = _ell_consts(ell)
        h = 1e-5

        def fwd(lon_, lat_):
            return transform_points('EPSG:4326', f'EPSG:{epsg}',
                                    lon_, lat_)
        xpl, ypl = fwd(lon + h, lat)
        xml, yml = fwd(lon - h, lat)
        xpp, ypp = fwd(lon, lat + h)
        xmp, ymp = fwd(lon, lat - h)
        dxdlon = (xpl - xml) / (2 * h)
        dydlon = (ypl - yml) / (2 * h)
        dxdlat = (xpp - xmp) / (2 * h)
        dydlat = (ypp - ymp) / (2 * h)
        det = np.abs(dxdlon * dydlat - dxdlat * dydlon)
        latr = np.radians(lat)
        s = np.sin(latr)
        true = (a * a * (1 - e2) * np.cos(latr)
                / (1 - e2 * s * s) ** 2) * np.radians(1.0) ** 2
        assert np.abs(det / true - 1.0).max() < 1e-5

    @pytest.mark.parametrize('epsg', [5070, 3577, 3035, 6931, 6932])
    def test_wkt_proj4_roundtrip(self, epsg):
        from proteus_jax.geo.crs import CRS
        crs = CRS.from_epsg(epsg)
        assert CRS.from_wkt(crs.to_wkt()).epsg == epsg
        assert CRS.from_proj4(crs.to_proj4()).epsg == epsg
        # authority-free WKT falls back to parameter matching
        import re as _re
        no_auth = _re.sub(r',?AUTHORITY\[[^\]]*\]', '', crs.to_wkt())
        assert CRS.from_wkt(no_auth).epsg == epsg

    @pytest.mark.parametrize('epsg,tile_proj,tile_xy', [
        (5070, 'EPSG:32615', (500000.0, 4983000.0)),   # Minnesota
        (3035, 'EPSG:32632', (500000.0, 5540000.0)),   # Germany
    ])
    def test_equal_area_dem_warp_device_matches_host(
            self, tmp_path, epsg, tile_proj, tile_xy):
        """A DEM delivered in an equal-area grid warped onto a UTM
        tile: accepted by the coverage check, and device warp
        bit-identical to host."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        rng = np.random.default_rng(epsg)
        h = w = 300
        cx, cy = transform_points(tile_proj, f'EPSG:{epsg}',
                                  np.array([tile_xy[0] + 1800.0]),
                                  np.array([tile_xy[1] - 1500.0]))
        gt = (float(cx[0]) - 150 * 60.0, 60.0, 0.0,
              float(cy[0]) + 150 * 60.0, 0.0, -60.0)
        arr = (500 + 100 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        path = str(tmp_path / f'ea_{epsg}_dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=epsg,
                  nodata=float('nan'), overview_levels=())
        tile_gt = (tile_xy[0], 30.0, 0.0, tile_xy[1], 0.0, -30.0)
        check_ancillary_inputs(True, False, path, path, path, None,
                               tile_gt, tile_proj, 100, 120, {})
        for alg in ('nearest', 'bilinear', 'cubic'):
            host = warp_to_grid(path, tile_gt, tile_proj, 100, 120,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            nn = np.isnan(host)
            assert (~nn).any(), f'tile missed the EPSG:{epsg} source'
            dev = np.asarray(warp_to_grid_device(
                path, tile_gt, tile_proj, 100, 120,
                resample_algorithm=alg, margin_in_pixels=10))
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), f'{alg}: {bad.sum()} mismatches'


class TestLambertConformalConic:
    """LCC 2SP grids (round-3 widening): Canada Atlas Lambert
    (EPSG:3978, CDEM/HRDEM deliveries) and Lambert-93 (EPSG:2154, IGN
    France). Reference accepts them through OSR,
    dswx_hls.py:3385-3461."""

    _DOMAINS = {3978: (42, 83, -141, -52), 2154: (41, 51, -5, 10)}

    def test_lcc_snyder_numerical_example(self):
        """Snyder 1987 Appendix numerical example for the ellipsoidal
        LCC 2SP (Clarke 1866, sp 33/45, origin 23N 96W): 35N 75W ->
        x 1894410.9, y 1564649.5 (published to 0.1 m)."""
        from proteus_jax.geo import crs
        crs._ELLIPSOIDS.setdefault(
            'CLARKE1866', (6378206.4, 294.9786982139006))
        x, y = crs.lcc_forward(35.0, -75.0, 'CLARKE1866',
                               23.0, -96.0, 33.0, 45.0, 0.0, 0.0)
        assert abs(x - 1894410.9) < 0.5
        assert abs(y - 1564649.5) < 0.5

    def test_origin_anchors(self):
        from proteus_jax.geo.crs import CRS, lcc_forward
        x, y = lcc_forward(46.5, 3.0, *CRS.from_epsg(2154).lcc)
        assert abs(x - 700000.0) < 1e-6 and abs(y - 6600000.0) < 1e-6
        x, y = lcc_forward(49.0, -95.0, *CRS.from_epsg(3978).lcc)
        assert abs(x) < 1e-6 and abs(y) < 1e-6

    @pytest.mark.parametrize('epsg', [3978, 2154])
    def test_roundtrip_conformality_and_sp_scale(self, epsg):
        """Forward/inverse closure; meridian scale == parallel scale
        everywhere (conformality); k = 1 along both standard parallels
        — together these pin the 2SP constants without pyproj."""
        from proteus_jax.geo.crs import CRS, _ell_consts, lcc_forward, \
            lcc_inverse
        p = CRS.from_epsg(epsg).lcc
        rng = np.random.default_rng(epsg)
        la, lb, lo, hi = self._DOMAINS[epsg]
        lat = rng.uniform(la, lb, 500)
        lon = rng.uniform(lo, hi, 500)
        x, y = lcc_forward(lat, lon, *p)
        la2, lo2 = lcc_inverse(x, y, *p)
        assert np.abs(la2 - lat).max() < 1e-10
        assert np.abs(lo2 - lon).max() < 1e-10
        a, e2, _ = _ell_consts(p[0])
        h = 1e-6
        x1, y1 = lcc_forward(lat + h, lon, *p)
        x2, y2 = lcc_forward(lat, lon + h, *p)
        latr = np.radians(lat)
        W = np.sqrt(1 - e2 * np.sin(latr) ** 2)
        k_m = np.hypot(x1 - x, y1 - y) / (np.radians(h)
                                          * a * (1 - e2) / W ** 3)
        k_p = np.hypot(x2 - x, y2 - y) / (np.radians(h)
                                          * a * np.cos(latr) / W)
        assert np.abs(k_m / k_p - 1).max() < 1e-6
        for sp in (p[3], p[4]):
            xa, ya = lcc_forward(sp, p[2], *p)
            xb, yb = lcc_forward(sp, p[2] + 1e-3, *p)
            latr = np.radians(sp)
            d_true = (np.radians(1e-3) * a * np.cos(latr)
                      / np.sqrt(1 - e2 * np.sin(latr) ** 2))
            assert abs(np.hypot(xb - xa, yb - ya) / d_true - 1) < 1e-9

    @pytest.mark.parametrize('epsg', [3978, 2154])
    def test_wkt_proj4_roundtrip(self, epsg):
        from proteus_jax.geo.crs import CRS
        crs = CRS.from_epsg(epsg)
        assert CRS.from_wkt(crs.to_wkt()).epsg == epsg
        assert CRS.from_proj4(crs.to_proj4()).epsg == epsg
        import re as _re
        no_auth = _re.sub(r',?AUTHORITY\[[^\]]*\]', '', crs.to_wkt())
        assert CRS.from_wkt(no_auth).epsg == epsg

    def test_lcc_dem_warp_device_matches_host(self, tmp_path):
        """A DEM delivered in Canada Atlas Lambert (EPSG:3978) warped
        onto a UTM 14N tile: accepted by the coverage check, device
        warp bit-identical to host."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        rng = np.random.default_rng(3978)
        h = w = 300
        tile_xy = (500000.0, 6094000.0)   # ~55N, 99W (Manitoba)
        cx, cy = transform_points('EPSG:32614', 'EPSG:3978',
                                  np.array([tile_xy[0] + 1800.0]),
                                  np.array([tile_xy[1] - 1500.0]))
        gt = (float(cx[0]) - 150 * 60.0, 60.0, 0.0,
              float(cy[0]) + 150 * 60.0, 0.0, -60.0)
        arr = (300 + 80 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        path = str(tmp_path / 'lcc_dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=3978,
                  nodata=float('nan'), overview_levels=())
        tile_gt = (tile_xy[0], 30.0, 0.0, tile_xy[1], 0.0, -30.0)
        check_ancillary_inputs(True, False, path, path, path, None,
                               tile_gt, 'EPSG:32614', 100, 120, {})
        for alg in ('nearest', 'bilinear', 'cubic'):
            host = warp_to_grid(path, tile_gt, 'EPSG:32614', 100, 120,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            nn = np.isnan(host)
            assert (~nn).any(), 'tile missed the LCC source'
            dev = np.asarray(warp_to_grid_device(
                path, tile_gt, 'EPSG:32614', 100, 120,
                resample_algorithm=alg, margin_in_pixels=10))
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), f'{alg}: {bad.sum()} mismatches'


class TestUserDefinedCrs:
    """USER-DEFINED CRS (GeoTIFF PCS 32767 / authority-free WKT /
    parameterized proj4) within the implemented projection families —
    closing the reference's 'any OSR-resolvable SRS' contract
    (dswx_hls.py:3385-3461) for arbitrary parameters, not just the
    registry grids."""

    OSGB_WKT = (
        'PROJCS["OSGB36 / British National Grid",GEOGCS["OSGB36",'
        'DATUM["OSGB_1936",SPHEROID["Airy 1830",6377563.396,'
        '299.3249646]],PRIMEM["Greenwich",0],'
        'UNIT["degree",0.0174532925199433]],'
        'PROJECTION["Transverse_Mercator"],'
        'PARAMETER["latitude_of_origin",49],'
        'PARAMETER["central_meridian",-2],'
        'PARAMETER["scale_factor",0.9996012717],'
        'PARAMETER["false_easting",400000],'
        'PARAMETER["false_northing",-100000],UNIT["metre",1]]')

    def test_general_tm_osgb_worked_example(self):
        """OS 'A guide to coordinate systems in Great Britain' worked
        example: 52d39m27.2531sN 1d43m4.5177sE -> E 651409.903,
        N 313177.270 (general TM: non-zero lat0, negative fn, Airy
        1830) — parsed from authority-free WKT."""
        crs = CRS.from_wkt(self.OSGB_WKT)
        assert crs.custom is not None and crs.custom[0] == 'tm'
        lat = 52 + 39 / 60 + 27.2531 / 3600
        lon = 1 + 43 / 60 + 4.5177 / 3600
        E, N = transform_points('EPSG:4326', crs,
                                np.array([lon]), np.array([lat]))
        assert abs(E[0] - 651409.903) < 0.01
        assert abs(N[0] - 313177.270) < 0.01
        lon2, lat2 = transform_points(crs, 'EPSG:4326', E, N)
        assert abs(lat2[0] - lat) < 1e-9 and abs(lon2[0] - lon) < 1e-9

    def test_general_tm_reproduces_utm(self):
        """The parameterized TM engine with UTM parameters is the UTM
        engine, bit for bit."""
        from proteus_jax.geo.crs import tm_forward_general, utm_forward
        rng = np.random.default_rng(2)
        lat = rng.uniform(-80, 84, 500)
        lon = rng.uniform(-96, -90, 500)
        x1, y1 = utm_forward(lat, lon, 15, True)
        x2, y2 = tm_forward_general(lat, lon, 'WGS84', 0.0, -93.0,
                                    0.9996, 500000.0, 0.0)
        assert (x1 == x2).all() and (y1 == y2).all()

    def test_lcc_1sp_epsg_jamaica_worked_example(self):
        """EPSG Guidance Note 7-2 LCC 1SP worked example (Jamaica 1969
        National Grid, Clarke 1866): 17d55m55.8sN 76d56m37.26sW ->
        E 255966.58, N 142493.51."""
        from proteus_jax.geo import crs
        crs._ELLIPSOIDS.setdefault(
            'CLARKE1866', (6378206.4, 294.9786982139006))
        E, N = crs.lcc_forward(17 + 55 / 60 + 55.8 / 3600,
                               -(76 + 56 / 60 + 37.26 / 3600),
                               'CLARKE1866', 18.0, -77.0, 18.0, 18.0,
                               250000.0, 150000.0, 1.0)
        assert abs(E - 255966.58) < 0.01
        assert abs(N - 142493.51) < 0.01

    def test_wkt_proj4_geokey_roundtrips(self, tmp_path):
        """Custom CRS survive to_wkt/from_wkt, to_proj4/from_proj4, and
        a write_cog -> TiffReader.crs() geokey round-trip (PCS 32767 +
        parameter geokeys, GDAL's encoding of a non-EPSG SRS)."""
        from proteus_jax.io.tiff import TiffReader
        customs = [
            CRS.from_wkt(self.OSGB_WKT),
            # Texas Centric Albers (EPSG:3083's parameters, carried as
            # user-defined)
            CRS(32767, ('aea', 'GRS80', 18.0, -100.0, 27.5, 35.0,
                        1500000.0, 6000000.0)),
            CRS(32767, ('laea', 'WGS84', 45.0, -100.0, 0.0, 0.0)),
            CRS(32767, ('lcc', 'GRS80', 44.25, -109.5, 43.0, 45.5,
                        500000.0, 200000.0)),
            CRS(32767, ('ps', 60.0, -100.0, 1000.0, 2000.0, True,
                        None, 'WGS84')),
        ]
        arr = np.zeros((32, 32), np.float32)
        for i, c in enumerate(customs):
            assert CRS.from_wkt(c.to_wkt()) == c, c
            assert CRS.from_proj4(c.to_proj4()) == c, c
            p = str(tmp_path / f'c{i}.tif')
            write_cog(p, arr, geotransform=(0, 60, 0, 0, 0, -60),
                      epsg=c, overview_levels=())
            with TiffReader(p) as r:
                assert r.crs() == c, c
                assert r.epsg() is None

    def test_warp_and_coverage_with_user_defined_source(self, tmp_path):
        """A DEM in a user-defined Albers accepted by the coverage
        check; device warp bit-identical to host."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        tx = CRS(32767, ('aea', 'GRS80', 18.0, -100.0, 27.5, 35.0,
                         1500000.0, 6000000.0))
        tile_gt = (500000.0, 30.0, 0.0, 3430000.0, 0.0, -30.0)
        cx, cy = transform_points('EPSG:32614', tx,
                                  np.array([501800.0]),
                                  np.array([3428500.0]))
        rng = np.random.default_rng(7)
        h = w = 200
        arr = (500 + 100 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        p = str(tmp_path / 'tx_dem.tif')
        write_cog(p, arr,
                  geotransform=(float(cx[0]) - 100 * 60, 60.0, 0.0,
                                float(cy[0]) + 100 * 60, 0.0, -60.0),
                  epsg=tx, nodata=float('nan'), overview_levels=())
        check_ancillary_inputs(True, False, p, p, p, None, tile_gt,
                               'EPSG:32614', 100, 120, {})
        for alg in ('nearest', 'cubic'):
            host = warp_to_grid(p, tile_gt, 'EPSG:32614', 80, 100,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            dev = np.asarray(warp_to_grid_device(
                p, tile_gt, 'EPSG:32614', 80, 100,
                resample_algorithm=alg, margin_in_pixels=10))
            nn = np.isnan(host)
            assert (~nn).any()
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), (alg, int(bad.sum()))

    def test_unsupported_user_defined_rejected_at_coverage_check(
            self, tmp_path):
        """Geokeys outside the supported projection families fail with
        the reference's coverage-check error contract, not mid-warp."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        from proteus_jax.io import tiff as tiffmod
        import synthetic
        # CT 4 = Oblique Mercator Laborde (Hotine CT 3 is supported
        # as of the datum/omerc widening)
        with pytest.raises(ValueError, match='unsupported'):
            CRS.from_geokeys({1024: 1, 3072: 32767, 3075: 4,
                              2048: 4326, 3076: 9001})
        with pytest.raises(ValueError, match='linear units'):
            CRS.from_geokeys({1024: 1, 3072: 32767, 3075: 1,
                              2048: 4326, 3076: 9005})
        # end-to-end: a file carrying an unsupported method (CT 4,
        # Laborde) is rejected inside check_ancillary_inputs
        size = 64
        dem = synthetic.make_dem(str(tmp_path), size=size)
        p = str(tmp_path / 'weird.tif')
        write_cog(p, np.zeros((50, 50), np.float32),
                  geotransform=(0, 100, 0, 0, 0, -100),
                  epsg=CRS(32767, ('laea', 'WGS84', 45.0, -100.0,
                                   0.0, 0.0)),
                  overview_levels=())
        # rewrite the method geokey to CT 4 (Laborde)
        with open(p, 'rb') as fh:
            blob = bytearray(fh.read())
        with tiffmod.TiffReader(p) as r:
            kd = list(r.main.get(tiffmod.TAG_GEO_KEY_DIRECTORY))
        idx = kd.index(3075)
        kd[idx + 3] = 4
        import struct
        old = struct.pack('<%dH' % len(kd),
                          *r.main.get(tiffmod.TAG_GEO_KEY_DIRECTORY))
        new = struct.pack('<%dH' % len(kd), *kd)
        off = blob.find(old)
        assert off > 0
        blob[off:off + len(old)] = new
        with open(p, 'wb') as fh:
            fh.write(blob)
        with pytest.raises(ValueError, match='unsupported user-defined'):
            check_ancillary_inputs(True, False, p, dem, dem, None,
                                   synthetic.geotransform(),
                                   'EPSG:32615', size, size, {})


class TestMercator:
    """Mercator grids (round-3 widening): EPSG:3857 web mercator (the
    most common CRS of arbitrary delivered rasters), EPSG:3395 World
    Mercator, and user-defined variant A/B Mercator (GeoTIFF CT 7)."""

    def test_epsg_guidance_note_neiez_example(self):
        """EPSG GN7-2 Mercator variant A worked example (Makassar /
        NEIEZ, Bessel 1841, k0 0.997): 3S 120E -> E 5009726.58,
        N 569150.82."""
        from proteus_jax.geo import crs
        bes = crs._ensure_ellipsoid(6377397.155, 299.1528128)
        E, N = crs.mercator_forward(-3.0, 120.0, bes, 110.0, 0.997,
                                    3900000.0, 900000.0)
        assert abs(E - 5009726.58) < 0.01
        assert abs(N - 569150.82) < 0.01
        la, lo = crs.mercator_inverse(E, N, bes, 110.0, 0.997,
                                      3900000.0, 900000.0)
        assert abs(la + 3.0) < 1e-9 and abs(lo - 120.0) < 1e-9

    def test_web_mercator_knowns(self):
        """EPSG GN7-2's 3857 example + the spherical-on-geodetic-lat
        quirk (y(24d22m54.433s) == 2800000 exactly on the sphere)."""
        from proteus_jax.geo.crs import (web_mercator_forward,
                                         web_mercator_inverse)
        lat = 24 + 22 / 60 + 54.433 / 3600
        E, N = web_mercator_forward(lat, -(100 + 20 / 60))
        assert abs(E - -11169055.58) < 0.01
        assert abs(N - 2800000.00) < 0.01
        la, lo = web_mercator_inverse(E, N)
        assert abs(la - lat) < 1e-9

    @pytest.mark.parametrize('epsg', [3395, 3857])
    def test_roundtrip_and_serialization(self, epsg):
        from proteus_jax.geo.crs import CRS
        rng = np.random.default_rng(epsg)
        la0 = rng.uniform(-80, 80, 500)
        lo0 = rng.uniform(-179, 179, 500)
        x, y = transform_points('EPSG:4326', f'EPSG:{epsg}', lo0, la0)
        lo2, la2 = transform_points(f'EPSG:{epsg}', 'EPSG:4326', x, y)
        assert np.abs(la2 - la0).max() < 1e-9
        assert np.abs(lo2 - lo0).max() < 1e-9
        crs = CRS.from_epsg(epsg)
        assert CRS.from_wkt(crs.to_wkt()).epsg == epsg
        assert CRS.from_proj4(crs.to_proj4()).epsg == epsg

    def test_custom_merc_geokey_roundtrip(self, tmp_path):
        from proteus_jax.geo import crs
        from proteus_jax.io.tiff import TiffReader
        bes = crs._ensure_ellipsoid(6377397.155, 299.1528128)
        cm = crs.CRS(32767, ('merc', bes, 110.0, 0.997, 3900000.0,
                             900000.0))
        assert crs.CRS.from_wkt(cm.to_wkt()) == cm
        assert crs.CRS.from_proj4(cm.to_proj4()) == cm
        p = str(tmp_path / 'm.tif')
        write_cog(p, np.zeros((32, 32), np.float32),
                  geotransform=(0, 60, 0, 0, 0, -60), epsg=cm,
                  overview_levels=())
        with TiffReader(p) as r:
            assert r.crs() == cm

    def test_web_mercator_warp_device_matches_host(self, tmp_path):
        """A raster delivered in 3857 (e.g. a downloaded basemap-grid
        DEM) warped onto a UTM tile: coverage-accepted, device warp
        bit-identical to host."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        rng = np.random.default_rng(3857)
        h = w = 250
        tile_gt = (700000.0, 30.0, 0.0, 3395100.0, 0.0, -30.0)
        cx, cy = transform_points('EPSG:32615', 'EPSG:3857',
                                  np.array([703000.0]),
                                  np.array([3393000.0]))
        arr = (200 + 50 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        p = str(tmp_path / 'wm.tif')
        write_cog(p, arr,
                  geotransform=(float(cx[0]) - 125 * 70, 70.0, 0.0,
                                float(cy[0]) + 125 * 70, 0.0, -70.0),
                  epsg=3857, nodata=float('nan'), overview_levels=())
        check_ancillary_inputs(True, False, p, p, p, None, tile_gt,
                               'EPSG:32615', 100, 120, {})
        for alg in ('nearest', 'cubic'):
            host = warp_to_grid(p, tile_gt, 'EPSG:32615', 80, 100,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            dev = np.asarray(warp_to_grid_device(
                p, tile_gt, 'EPSG:32615', 80, 100,
                resample_algorithm=alg, margin_in_pixels=10))
            nn = np.isnan(host)
            assert (~nn).any()
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), (alg, int(bad.sum()))


class TestCrsReviewRegressions:
    """Regressions for the round-3 review of the CRS-widening commits:
    GDAL's user-defined-PCS encoding on the reader path, ellipsoid-
    aware registry matching, k0 survival for LCC, sphere rejection at
    parse time, and exponent-bearing numeric literals."""

    def test_gdal_encoded_user_defined_pcs_reads_projected(
            self, tmp_path):
        """GDAL writes a user-defined projected SRS as PCS 32767 plus
        GeographicTypeGeoKey = the KNOWN base-GCS code (e.g. 4269 for a
        NAD83-based custom LCC); TiffReader.crs() must route that
        through the parameter geokeys, not fall back to the geographic
        code (which silently treated metres as degrees)."""
        import struct
        from proteus_jax.io import tiff as tiffmod
        c = CRS(32767, ('lcc', 'GRS80', 44.25, -109.5, 43.0, 45.5,
                        500000.0, 200000.0))
        p = str(tmp_path / 'gdalenc.tif')
        write_cog(p, np.zeros((32, 32), np.float32),
                  geotransform=(0, 60, 0, 0, 0, -60), epsg=c,
                  overview_levels=())
        # rewrite geokey 2048 from 32767 (our encoding) to 4269
        # (GDAL's encoding: the known NAD83 geographic code)
        with open(p, 'rb') as fh:
            blob = bytearray(fh.read())
        with tiffmod.TiffReader(p) as r:
            kd = list(r.main.get(tiffmod.TAG_GEO_KEY_DIRECTORY))
        idx = kd.index(2048)
        assert kd[idx + 3] == 32767
        old = struct.pack('<%dH' % len(kd), *kd)
        kd[idx + 3] = 4269
        new = struct.pack('<%dH' % len(kd), *kd)
        off = blob.find(old)
        assert off > 0
        blob[off:off + len(old)] = new
        with open(p, 'wb') as fh:
            fh.write(blob)
        with tiffmod.TiffReader(p) as r:
            got = r.crs()
        assert got is not None and not got.is_geographic
        assert got.custom == c.custom

    def test_registry_match_requires_ellipsoid(self):
        """A legacy Clarke-1866 (NAD27-era) Albers with EPSG:5070's
        parameters must NOT silently remap onto the GRS80 registry code
        (~63 m error at 40N); it stays user-defined with the Clarke
        1866 ellipsoid. Same for WKT."""
        c = CRS.from_proj4('+proj=aea +lat_0=23 +lon_0=-96 +lat_1=29.5 '
                           '+lat_2=45.5 +x_0=0 +y_0=0 +ellps=clrk66')
        assert c.epsg == 32767 and c.custom[0] == 'aea'
        assert c.custom[1] != 'GRS80'
        wkt = ('PROJCS["NAD27 CONUS Albers",GEOGCS["NAD27",'
               'DATUM["North_American_Datum_1927",'
               'SPHEROID["Clarke 1866",6378206.4,294.978698213898]],'
               'PRIMEM["Greenwich",0],'
               'UNIT["degree",0.0174532925199433]],'
               'PROJECTION["Albers_Conic_Equal_Area"],'
               'PARAMETER["standard_parallel_1",29.5],'
               'PARAMETER["standard_parallel_2",45.5],'
               'PARAMETER["latitude_of_center",23],'
               'PARAMETER["longitude_of_center",-96],'
               'PARAMETER["false_easting",0],'
               'PARAMETER["false_northing",0],UNIT["metre",1]]')
        cw = CRS.from_wkt(wkt)
        assert cw.epsg == 32767 and cw.custom[1] != 'GRS80'
        # GRS80 parameters still hit the registry
        c80 = CRS.from_proj4('+proj=aea +lat_0=23 +lon_0=-96 '
                             '+lat_1=29.5 +lat_2=45.5 +x_0=0 +y_0=0 '
                             '+ellps=GRS80')
        assert c80.epsg == 5070

    def test_sphere_rejected_at_parse_time(self):
        """Spherical 'ellipsoids' (EASE-Grid v1 style +a==+b, or
        SPHEROID[...,0]) are rejected when the CRS is parsed — not by a
        ZeroDivisionError mid-warp, and never silently remapped onto
        the WGS84 EASE-Grid 2.0 codes (~7 km error)."""
        with pytest.raises(ValueError, match='spher'):
            CRS.from_proj4('+proj=laea +lat_0=90 +lon_0=0 +x_0=0 '
                           '+y_0=0 +a=6371228 +b=6371228')
        wkt = ('PROJCS["sphere merc",GEOGCS["GCS_Sphere",'
               'DATUM["D_Sphere",SPHEROID["sphere",6371000,0]],'
               'PRIMEM["Greenwich",0],'
               'UNIT["degree",0.0174532925199433]],'
               'PROJECTION["Mercator_1SP"],'
               'PARAMETER["central_meridian",0],'
               'PARAMETER["scale_factor",1],'
               'PARAMETER["false_easting",0],'
               'PARAMETER["false_northing",0],UNIT["metre",1]]')
        with pytest.raises(ValueError, match='spherical|ellipsoid'):
            CRS.from_wkt(wkt)

    def test_lcc_1sp_k0_survives_geokey_roundtrip(self, tmp_path):
        """An LCC 1SP custom CRS with k0 != 1 (French legacy Lambert
        zone style) keeps its scale factor through write_cog ->
        TiffReader.crs() (geokey 3092 on CT 8)."""
        from proteus_jax.io.tiff import TiffReader
        c = CRS(32767, ('lcc', 'GRS80', 46.8, 2.337, 46.8, 46.8,
                        600000.0, 200000.0, 0.99987742))
        assert CRS.from_wkt(c.to_wkt()) == c
        assert CRS.from_proj4(c.to_proj4()) == c
        p = str(tmp_path / 'lcck0.tif')
        write_cog(p, np.zeros((32, 32), np.float32),
                  geotransform=(0, 60, 0, 0, 0, -60), epsg=c,
                  overview_levels=())
        with TiffReader(p) as r:
            assert r.crs() == c

    def test_negative_exponent_literals(self):
        """Numeric literals with negative exponents (2.95e-1) parse in
        both WKT PARAMETER[] and proj4 +key= values instead of silently
        falling back to defaults."""
        c = CRS.from_proj4('+proj=aea +lat_0=23 +lon_0=-96 '
                           '+lat_1=2.95e-1 +lat_2=45.5 +x_0=0 +y_0=0 '
                           '+ellps=GRS80')
        assert c.custom[4] == pytest.approx(0.295)
        wkt = ('PROJCS["neg exp",GEOGCS["NAD83",'
               'DATUM["North_American_Datum_1983",'
               'SPHEROID["GRS 1980",6378137,298.257222101]],'
               'PRIMEM["Greenwich",0],'
               'UNIT["degree",0.0174532925199433]],'
               'PROJECTION["Albers_Conic_Equal_Area"],'
               'PARAMETER["standard_parallel_1",2.95e-1],'
               'PARAMETER["standard_parallel_2",45.5],'
               'PARAMETER["latitude_of_center",23],'
               'PARAMETER["longitude_of_center",-96],'
               'PARAMETER["false_easting",0],'
               'PARAMETER["false_northing",0],UNIT["metre",1]]')
        cw = CRS.from_wkt(wkt)
        assert cw.custom[4] == pytest.approx(0.295)


class TestLinearUnits:
    """Foot-based projected CRS (US State Plane style): the reference
    accepts them through OSR (dswx_hls.py:3385-3461); geokey 3076 =
    9002/9003, WKT UNIT[], proj4 +units=/+to_meter."""

    def _spcs27_texas(self):
        from proteus_jax.geo import crs
        clk = crs._ensure_ellipsoid(6378206.4, 294.9786982139006)
        return CRS(32767, ('lcc', clk, 27 + 50 / 60, -99.0,
                           28 + 23 / 60, 30 + 17 / 60, 2000000.0, 0.0),
                   crs._US_FOOT)

    def test_snyder_spcs27_texas_worked_example(self):
        """Snyder's LCC 2SP numerical example (SPCS27 Texas South
        Central, Clarke 1866, US survey feet): 28d30'N 96dW ->
        x 2,963,503.91 ft, y 254,759.80 ft."""
        ft = self._spcs27_texas()
        x, y = transform_points('EPSG:4326', ft, np.array([-96.0]),
                                np.array([28.5]))
        assert abs(x[0] - 2963503.91) < 0.01
        assert abs(y[0] - 254759.80) < 0.01
        lo, la = transform_points(ft, 'EPSG:4326', x, y)
        assert abs(lo[0] + 96.0) < 1e-9 and abs(la[0] - 28.5) < 1e-9

    def test_unit_scaling_is_exactly_a_metre_rescale(self):
        """A foot CRS is its metre twin with coordinates divided by the
        unit: same projection core, origin maps to (FE, FN) in native
        feet."""
        from proteus_jax.geo.crs import _US_FOOT
        ft = CRS(32767, ('lcc', 'GRS80', 39.0 + 1 / 3, -122.0, 40.0,
                         41.0 + 2 / 3, 6561666.666666666,
                         1640416.6666666667), _US_FOOT)
        m = CRS(32767, ('lcc', 'GRS80', 39.0 + 1 / 3, -122.0, 40.0,
                        41.0 + 2 / 3,
                        6561666.666666666 * _US_FOOT,
                        1640416.6666666667 * _US_FOOT))
        rng = np.random.default_rng(2225)
        lon = rng.uniform(-124, -120, 200)
        lat = rng.uniform(38, 42, 200)
        xf, yf = transform_points('EPSG:4326', ft, lon, lat)
        xm, ym = transform_points('EPSG:4326', m, lon, lat)
        assert np.abs(xf * _US_FOOT - xm).max() < 1e-6
        assert np.abs(yf * _US_FOOT - ym).max() < 1e-6
        x0, y0 = transform_points('EPSG:4326', ft,
                                  np.array([-122.0]),
                                  np.array([39.0 + 1 / 3]))
        assert abs(x0[0] - 6561666.666666666) < 1e-6
        assert abs(y0[0] - 1640416.6666666667) < 1e-6

    def test_serialization_roundtrips(self, tmp_path):
        """WKT / proj4 / geokey round-trips preserve the unit and the
        native-unit false easting/northing exactly. proj4 +x_0 is
        emitted in METRES (PROJ's convention) with +units=us-ft."""
        from proteus_jax.io.tiff import TiffReader
        from proteus_jax.geo.crs import _FOOT, _US_FOOT
        ft = self._spcs27_texas()
        p4 = ft.to_proj4()
        assert '+units=us-ft' in p4
        assert '+x_0=609601.2192024384' in p4      # 2e6 ftUS in metres
        assert CRS.from_proj4(p4) == ft
        wkt = ft.to_wkt()
        assert 'US survey foot' in wkt
        assert 'PARAMETER["false_easting",2000000.0]' in wkt  # native
        assert CRS.from_wkt(wkt) == ft
        p = str(tmp_path / 'spcs.tif')
        write_cog(p, np.zeros((32, 32), np.float32),
                  geotransform=(0, 200, 0, 0, 0, -200), epsg=ft,
                  overview_levels=())
        with TiffReader(p) as r:
            assert r.crs() == ft
        intl = CRS(32767, ('tm', 'WGS84', 0.0, -75.0, 0.9996,
                           500000.0, 0.0), _FOOT)
        assert '+units=ft' in intl.to_proj4()
        assert CRS.from_proj4(intl.to_proj4()) == intl
        assert CRS.from_wkt(intl.to_wkt()) == intl
        # +to_meter= spelling of the same unit
        c = CRS.from_proj4('+proj=tmerc +lat_0=0 +lon_0=-75 +k=0.9996 '
                           '+x_0=152400 +y_0=0 +ellps=WGS84 '
                           '+to_meter=0.3048')
        assert c == intl

    def test_foot_dem_warp_device_matches_host(self, tmp_path):
        """A DEM delivered in a ftUS State Plane grid: accepted by the
        coverage check, device warp bit-identical to host."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        from proteus_jax.geo.crs import _US_FOOT
        ft = CRS(32767, ('lcc', 'GRS80', 39.0 + 1 / 3, -122.0, 40.0,
                         41.0 + 2 / 3, 6561666.666666666,
                         1640416.6666666667), _US_FOOT)
        tile_gt = (560000.0, 30.0, 0.0, 4540000.0, 0.0, -30.0)
        cx, cy = transform_points('EPSG:32610', ft,
                                  np.array([561800.0]),
                                  np.array([4538500.0]))
        rng = np.random.default_rng(27)
        h = w = 200
        arr = (500 + 100 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        p = str(tmp_path / 'spcs_dem.tif')
        cell = 200.0    # ~61 m cells, in feet
        write_cog(p, arr,
                  geotransform=(float(cx[0]) - 100 * cell, cell, 0.0,
                                float(cy[0]) + 100 * cell, 0.0, -cell),
                  epsg=ft, nodata=float('nan'), overview_levels=())
        check_ancillary_inputs(True, False, p, p, p, None, tile_gt,
                               'EPSG:32610', 100, 120, {})
        for alg in ('nearest', 'cubic'):
            host = warp_to_grid(p, tile_gt, 'EPSG:32610', 80, 100,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            dev = np.asarray(warp_to_grid_device(
                p, tile_gt, 'EPSG:32610', 80, 100,
                resample_algorithm=alg, margin_in_pixels=10))
            nn = np.isnan(host)
            assert (~nn).any()
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), (alg, int(bad.sum()))


class TestSinusoidalAndCea:
    """Sinusoidal (the MODIS land-product grid — authalic sphere
    R=6371007.181 — plus ESRI:54008-style ellipsoidal) and Lambert
    Cylindrical Equal Area (EPSG:6933, NSIDC EASE-Grid 2.0 global:
    SMAP/AMSR snow & soil-moisture rasters)."""

    def _modis(self):
        from proteus_jax.geo.crs import MODIS_SPHERE_RADIUS
        return CRS(32767, ('sinu', MODIS_SPHERE_RADIUS, 0.0, 0.0, 0.0))

    def test_modis_grid_constants(self):
        """On the MODIS sphere the 10-degree tile width is exactly
        R*radians(10) = 1,111,950.5198 m and y = R*lat_rad."""
        from proteus_jax.geo.crs import MODIS_SPHERE_RADIUS as R
        sinu = self._modis()
        x, y = transform_points('EPSG:4326', sinu, np.array([10.0]),
                                np.array([0.0]))
        assert abs(x[0] - R * np.radians(10)) < 1e-6 and y[0] == 0.0
        x, y = transform_points('EPSG:4326', sinu, np.array([0.0]),
                                np.array([40.0]))
        assert x[0] == 0.0 and abs(y[0] - R * np.radians(40)) < 1e-6

    def test_ease2_published_extent(self):
        """EPSG:6933 x(180) matches NSIDC's published EASE-Grid 2.0
        global map half-width 17,367,530.445161 m."""
        x, _ = transform_points('EPSG:4326', 'EPSG:6933',
                                np.array([180.0]), np.array([0.0]))
        assert abs(abs(x[0]) - 17367530.445161) < 1e-3

    @pytest.mark.parametrize('crs_key', ['modis', 'esri54008', '6933'])
    def test_roundtrip(self, crs_key):
        crs = {'modis': self._modis(),
               'esri54008': CRS(32767, ('sinu', 'WGS84', 0.0, 0.0,
                                        0.0)),
               '6933': CRS(6933)}[crs_key]
        rng = np.random.default_rng(hash(crs_key) % 2 ** 31)
        lon = rng.uniform(-179, 179, 2000)
        lat = rng.uniform(-85, 85, 2000)
        x, y = transform_points('EPSG:4326', crs, lon, lat)
        lo, la = transform_points(crs, 'EPSG:4326', x, y)
        assert np.abs(lo - lon).max() < 1e-9
        assert np.abs(la - lat).max() < 1e-9

    @pytest.mark.parametrize('crs_key', ['modis', 'esri54008', '6933'])
    def test_equal_area_jacobian(self, crs_key):
        """Both projections are equal-area: |J| of (lon,lat)->(x,y)
        equals the ellipsoidal/spherical area element everywhere."""
        from proteus_jax.geo import crs as crsmod
        crs = {'modis': self._modis(),
               'esri54008': CRS(32767, ('sinu', 'WGS84', 0.0, 0.0,
                                        0.0)),
               '6933': CRS(6933)}[crs_key]
        if crs_key == 'modis':
            a, e2 = crsmod.MODIS_SPHERE_RADIUS, 0.0
        else:
            a, e2, _ = crsmod._ell_consts('WGS84')
        rng = np.random.default_rng(len(crs_key))
        lon = rng.uniform(-170, 170, 300)
        lat = rng.uniform(-80, 80, 300)
        d = 1e-6
        x0, y0 = transform_points('EPSG:4326', crs, lon, lat)
        x1, y1 = transform_points('EPSG:4326', crs, lon + d, lat)
        x2, y2 = transform_points('EPSG:4326', crs, lon, lat + d)
        J = np.abs((x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0))
        s = np.sin(np.radians(lat))
        # dA = a^2 (1-e2) cos(phi) / (1-e2 sin^2)^2 dphi dlam
        dA = (a * a * (1 - e2) * np.cos(np.radians(lat))
              / (1 - e2 * s * s) ** 2 * np.radians(d) ** 2)
        assert np.abs(J / dA - 1.0).max() < 1e-4

    def test_serialization_roundtrips(self, tmp_path):
        """WKT / proj4 / geokey round-trips, incl. the sphere radius
        (SPHEROID inverse flattening 0 is legal HERE and only here)."""
        from proteus_jax.io.tiff import TiffReader
        customs = [self._modis(),
                   CRS(32767, ('sinu', 'WGS84', 0.0, 0.0, 0.0)),
                   CRS(32767, ('cea', 'WGS84', 30.0, 10.0, 100.0,
                               200.0))]
        arr = np.zeros((32, 32), np.float32)
        for i, c in enumerate(customs):
            assert CRS.from_wkt(c.to_wkt()) == c, c.to_wkt()
            assert CRS.from_proj4(c.to_proj4()) == c, c.to_proj4()
            p = str(tmp_path / f's{i}.tif')
            write_cog(p, arr, geotransform=(0, 463.3127, 0, 0, 0,
                                            -463.3127),
                      epsg=c, overview_levels=())
            with TiffReader(p) as r:
                assert r.crs() == c
        assert CRS.from_wkt(CRS(6933).to_wkt()).epsg == 6933
        assert CRS.from_proj4(CRS(6933).to_proj4()).epsg == 6933
        # GDAL's MODIS proj4 spelling
        g = CRS.from_proj4('+proj=sinu +lon_0=0 +x_0=0 +y_0=0 '
                           '+R=6371007.181 +units=m +no_defs')
        assert g == self._modis()
        g2 = CRS.from_proj4('+proj=sinu +a=6371007.181 +b=6371007.181 '
                            '+lon_0=0 +x_0=0 +y_0=0 +units=m +no_defs')
        assert g2 == self._modis()

    def test_modis_landcover_warp_device_matches_host(self, tmp_path):
        """A landcover-style raster on the MODIS sinusoidal grid:
        coverage-accepted, device warp bit-identical to host."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        sinu = self._modis()
        tile_gt = (600000.0, 30.0, 0.0, 3300000.0, 0.0, -30.0)
        cx, cy = transform_points('EPSG:32615', sinu,
                                  np.array([601800.0]),
                                  np.array([3298500.0]))
        rng = np.random.default_rng(463)
        h = w = 200
        arr = (500 + 100 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        p = str(tmp_path / 'modis.tif')
        cell = 463.31271653     # the MODIS 500 m cell
        write_cog(p, arr,
                  geotransform=(float(cx[0]) - 100 * cell, cell, 0.0,
                                float(cy[0]) + 100 * cell, 0.0, -cell),
                  epsg=sinu, nodata=float('nan'), overview_levels=())
        check_ancillary_inputs(True, False, p, p, p, None, tile_gt,
                               'EPSG:32615', 100, 120, {})
        for alg in ('nearest', 'cubic'):
            host = warp_to_grid(p, tile_gt, 'EPSG:32615', 80, 100,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            dev = np.asarray(warp_to_grid_device(
                p, tile_gt, 'EPSG:32615', 80, 100,
                resample_algorithm=alg, margin_in_pixels=10))
            nn = np.isnan(host)
            assert (~nn).any()
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), (alg, int(bad.sum()))


class TestAverageResampler:
    """GDAL GRA_Average semantics: area-weighted mean over the target
    pixel's source-space footprint bbox, nodata renormalized."""

    def _brute_force(self, fdata, valid, uc, vc, fill, wraps, width):
        h, w = fdata.shape
        rows, cols = uc.shape[0] - 1, uc.shape[1] - 1
        out = np.full((rows, cols), fill, np.float64)
        for i in range(rows):
            for j in range(cols):
                xs = [uc[i, j], uc[i, j + 1], uc[i + 1, j],
                      uc[i + 1, j + 1]]
                ys = [vc[i, j], vc[i, j + 1], vc[i + 1, j],
                      vc[i + 1, j + 1]]
                if wraps:
                    x0 = xs[0]
                    xs = [x - width * round((x - x0) / width)
                          for x in xs]
                if not all(np.isfinite(xs + ys)):
                    continue
                xmin, xmax = min(xs), max(xs)
                ymin, ymax = min(ys), max(ys)
                acc = wacc = 0.0
                for cy in range(int(np.floor(ymin)),
                                int(np.ceil(ymax)) + 1):
                    wy = max(0.0, min(cy + 1, ymax) - max(cy, ymin))
                    if wy <= 0 or cy < 0 or cy >= h:
                        continue
                    for cx in range(int(np.floor(xmin)),
                                    int(np.ceil(xmax)) + 1):
                        wx = max(0.0, min(cx + 1, xmax) - max(cx, xmin))
                        if wx <= 0:
                            continue
                        cxx = cx % width if wraps else cx
                        if cxx < 0 or cxx >= w:
                            continue
                        if valid is not None and not valid[cy, cxx]:
                            continue
                        acc += fdata[cy, cxx] * wx * wy
                        wacc += wx * wy
                if wacc > 0:
                    out[i, j] = acc / wacc
        return out

    @pytest.mark.parametrize('wraps', [False, True])
    def test_block_matches_brute_force(self, wraps):
        from proteus_jax.geo.warp import _resample_block_average
        rng = np.random.default_rng(21)
        h, w = 40, 60
        fdata = rng.normal(0, 100, (h, w))
        valid = rng.random((h, w)) > 0.1
        rows, cols = 12, 15
        # random smooth footprints, 0.5..4 source cells across
        base_u = np.cumsum(rng.uniform(0.5, 4.0, cols + 1)) + \
            (w - 10 if wraps else 3)
        base_v = np.cumsum(rng.uniform(0.5, 4.0, rows + 1)) + 2
        uc = base_u[None, :] + rng.normal(0, 0.2, (rows + 1, cols + 1))
        vc = base_v[:, None] + rng.normal(0, 0.2, (rows + 1, cols + 1))
        if wraps:
            uc = uc % w
        got = _resample_block_average(fdata, valid, uc, vc, -999.0,
                                      wraps, w)
        want = self._brute_force(fdata, valid, uc, vc, -999.0, wraps, w)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)

    def test_warp_average_constant_and_blockmean(self, tmp_path):
        """An aligned 3x downsample must reproduce exact block means."""
        rng = np.random.default_rng(5)
        h = w = 90
        arr = rng.integers(0, 1000, (h, w)).astype(np.float32)
        # source: 10 m UTM grid; target: 30 m grid on the same origin
        gt = (500000.0, 10.0, 0.0, 4000000.0, 0.0, -10.0)
        path = str(tmp_path / 'avg_src.tif')
        write_cog(path, arr, geotransform=gt, epsg=32615,
                  overview_levels=())
        tile_gt = (500000.0, 30.0, 0.0, 4000000.0, 0.0, -30.0)
        out = warp_to_grid(path, tile_gt, 'EPSG:32615', 30, 30,
                           resample_algorithm='average',
                           dtype=np.float64)
        want = arr.astype(np.float64).reshape(30, 3, 30, 3).mean((1, 3))
        np.testing.assert_allclose(out, want, rtol=1e-7)

    def test_warp_average_nodata_and_device_route(self, latlon_source):
        path, gt, arr = latlon_source
        tile_gt = (700000.0, 90.0, 0.0, 3395100.0, 0.0, -90.0)
        host = warp_to_grid(path, tile_gt, 'EPSG:32615', 40, 40,
                            resample_algorithm='average')
        dev = np.asarray(warp_to_grid_device(
            path, tile_gt, 'EPSG:32615', 40, 40,
            resample_algorithm='average'))
        nn = (host != host) & (dev != dev)
        assert ((host == dev) | nn).all()


class TestRasterizer:
    def test_matches_brute_force_point_in_polygon(self):
        from proteus_jax.geo.polygon import rasterize_rings
        rng = np.random.default_rng(8)
        gt = (0.0, 1.0, 0.0, 40.0, 0.0, -1.0)
        H = Wd = 40
        for trial in range(20):
            n = int(rng.integers(3, 12))
            ring = np.stack([rng.uniform(-5, 45, n),
                             rng.uniform(-5, 45, n)], axis=1)
            got = rasterize_rings([ring], gt, H, Wd)
            # brute force even-odd test at pixel centers
            yy, xx = np.mgrid[0:H, 0:Wd]
            cx = gt[0] + (xx + 0.5) * gt[1]
            cy = gt[3] + (yy + 0.5) * gt[5]
            inside = np.zeros((H, Wd), bool)
            x1, y1 = ring[:, 0], ring[:, 1]
            x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
            for k in range(n):
                cond = ((y1[k] <= cy) != (y2[k] <= cy))
                with np.errstate(divide='ignore', invalid='ignore'):
                    xint = x1[k] + (cy - y1[k]) / (y2[k] - y1[k]) \
                        * (x2[k] - x1[k])
                inside ^= cond & (cx < xint)
            np.testing.assert_array_equal(got.astype(bool), inside,
                                          err_msg=f'trial {trial}')

    def test_holes_even_odd(self):
        from proteus_jax.geo.polygon import rasterize_rings
        gt = (0.0, 1.0, 0.0, 20.0, 0.0, -1.0)
        outer = np.array([[2, 2], [18, 2], [18, 18], [2, 18]], float)
        hole = np.array([[8, 8], [12, 8], [12, 12], [8, 12]], float)
        got = rasterize_rings([outer, hole], gt, 20, 20)
        assert got[5, 5] == 1          # inside outer
        assert got[10, 10] == 0        # inside the hole
        assert got[0, 0] == 0          # outside

    def test_large_polygon_fast(self):
        import time
        from proteus_jax.geo.polygon import rasterize_rings
        rng = np.random.default_rng(9)
        # 100k-vertex wiggly circle (GSHHS-scale shoreline)
        n = 100_000
        th = np.linspace(0, 2 * np.pi, n, endpoint=False)
        r = 1500 + 100 * np.sin(37 * th) + rng.normal(0, 5, n)
        ring = np.stack([2000 + r * np.cos(th), 2000 + r * np.sin(th)],
                        axis=1)
        gt = (0.0, 1.0, 0.0, 4000.0, 0.0, -1.0)
        # this box's wall-clock varies >2x run to run; take the best of 2
        dt = float('inf')
        for _ in range(2):
            t0 = time.time()
            got = rasterize_rings([ring], gt, 4000, 4000)
            dt = min(dt, time.time() - t0)
            if dt < 6.0:
                break
        assert dt < 6.0, f'rasterization too slow: {dt:.1f}s'
        # area sanity: ~ pi * 1500^2
        assert abs(got.sum() - np.pi * 1500 ** 2) < 0.02 * np.pi * 1500**2
