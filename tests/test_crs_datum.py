"""Datum transformation (TOWGS84 / Helmert) tests.

The reference resolves ANY OSR SRS and OSR applies the parametric
Helmert shift the SRS carries (WKT TOWGS84[] / proj4 +towgs84=) when
transforming between datums (dswx_hls.py:3385-3461 accepts the SRS;
osr.CoordinateTransformation applies the datum path). These tests pin
our geocentric/Helmert engine to the EPSG Guidance Note 7-2 worked
examples and verify the classical-datum registry CRS (OSGB36, ED50,
NAD27, Tokyo, Pulkovo 1942, CH1903) end-to-end.
"""

import numpy as np
import pytest

from proteus_jax.geo.crs import (
    CRS, geodetic_to_geocentric, geocentric_to_geodetic,
    helmert_position_vector, shift_datum, transform_points)
from proteus_jax.geo.warp import warp_to_grid, warp_to_grid_device
from proteus_jax.io.cog import write_cog
from proteus_jax.io.tiff import TiffReader


def _dms(d, m, s):
    return d + m / 60.0 + s / 3600.0


class TestGeocentric:
    def test_epsg_guidance_note_example(self):
        """EPSG GN7-2 §2.2 worked example (WGS84): 53°48'33.82"N,
        2°07'46.38"E, h=73.0 m -> X 3771793.968, Y 140253.342,
        Z 5124304.349."""
        lat, lon = _dms(53, 48, 33.82), _dms(2, 7, 46.38)
        x, y, z = geodetic_to_geocentric(lat, lon, 'WGS84', h=73.0)
        assert abs(x - 3771793.968) < 1e-3
        assert abs(y - 140253.342) < 1e-3
        assert abs(z - 5124304.349) < 1e-3

    def test_roundtrip_exact(self):
        rng = np.random.default_rng(7)
        lat = rng.uniform(-89.9, 89.9, 1000)
        lon = rng.uniform(-180, 180, 1000)
        for ell in ('WGS84', 'AIRY1830', 'BESSEL1841', 'KRASS1940'):
            x, y, z = geodetic_to_geocentric(lat, lon, ell)
            la, lo = geocentric_to_geodetic(x, y, z, ell)
            assert np.abs(la - lat).max() < 1e-12
            assert np.abs(lo - lon).max() < 1e-12

    def test_poles(self):
        x, y, z = geodetic_to_geocentric(
            np.array([90.0, -90.0]), np.array([0.0, 45.0]), 'WGS84')
        la, lo = geocentric_to_geodetic(x, y, z, 'WGS84')
        assert np.allclose(la, [90.0, -90.0], atol=1e-9)


class TestHelmert:
    # EPSG GN7-2 §2.4.3.2.1 position-vector worked example
    # (WGS72 -> WGS84, EPSG transformation 1238)
    P7 = (0.0, 0.0, 4.5, 0.0, 0.0, 0.554, 0.219)
    SRC = (3657660.66, 255768.55, 5201382.11)
    DST = (3657660.78, 255778.43, 5201387.75)

    def test_epsg_position_vector_example(self):
        x, y, z = helmert_position_vector(*self.SRC, self.P7)
        assert abs(x - self.DST[0]) < 0.01
        assert abs(y - self.DST[1]) < 0.01
        assert abs(z - self.DST[2]) < 0.01

    def test_exact_inverse(self):
        """inverse=True solves the forward relation exactly (not the
        negated-parameter approximation)."""
        x, y, z = helmert_position_vector(*self.SRC, self.P7)
        xs, ys, zs = helmert_position_vector(x, y, z, self.P7,
                                             inverse=True)
        assert abs(xs - self.SRC[0]) < 1e-8
        assert abs(ys - self.SRC[1]) < 1e-8
        assert abs(zs - self.SRC[2]) < 1e-8

    def test_translation_only(self):
        """3-parameter geocentric translation (EPSG 9603) is the
        rx=ry=rz=ds=0 case: plain vector addition."""
        p3 = (84.87, 96.49, 116.95, 0.0, 0.0, 0.0, 0.0)
        x, y, z = helmert_position_vector(100.0, 200.0, 300.0, p3)
        assert (x, y, z) == (184.87, 296.49, 416.95)


class TestShiftDatum:
    def test_identity_when_shifts_match(self):
        lat, lon = np.array([51.5]), np.array([-0.1])
        la, lo = shift_datum(lat, lon, 'WGS84', None, 'GRS80', None)
        assert la[0] == lat[0] and lo[0] == lon[0]
        p = (100.0, -50.0, 30.0, 0.0, 0.0, 0.0, 0.0)
        la, lo = shift_datum(lat, lon, 'WGS84', p, 'WGS84', p)
        assert la[0] == lat[0] and lo[0] == lon[0]

    def test_all_zero_is_null(self):
        lat, lon = np.array([51.5]), np.array([-0.1])
        la, lo = shift_datum(lat, lon, 'WGS84', (0.0,) * 7,
                             'GRS80', None)
        assert la[0] == lat[0] and lo[0] == lon[0]

    def test_ed50_direction_and_magnitude(self):
        """WGS84 -> ED50 over Europe moves coordinates north-east by
        roughly 2-5 arc-seconds (the classical European datum offset,
        EPSG GN7-2 §2.4.3.1 neighbourhood)."""
        la, lo = shift_datum(
            np.array([_dms(53, 48, 33.82)]),
            np.array([_dms(2, 7, 46.38)]),
            'WGS84', None, 'INTL1924',
            (-87.0, -98.0, -121.0, 0.0, 0.0, 0.0, 0.0))
        dlat_s = (la[0] - _dms(53, 48, 33.82)) * 3600
        dlon_s = (lo[0] - _dms(2, 7, 46.38)) * 3600
        assert 2.0 < dlat_s < 5.0, dlat_s
        assert 2.0 < dlon_s < 7.0, dlon_s


class TestClassicalDatumCrs:
    """Registry CRS on classical datums end-to-end through
    transform_points."""

    def test_bng_roundtrip(self):
        """WGS84 -> British National Grid -> WGS84. The residual is the
        inherent 2D-transform height discard (~mm), exactly like a
        grid-less OSR."""
        rng = np.random.default_rng(27700)
        lon = rng.uniform(-6, 1.5, 200)
        lat = rng.uniform(50, 58, 200)
        e, n = transform_points(4326, 27700, lon, lat)
        lo, la = transform_points(27700, 4326, e, n)
        # ~1e-7 deg = ~1 cm
        assert np.abs(lo - lon).max() < 2e-7
        assert np.abs(la - lat).max() < 2e-7

    def test_bng_datum_shift_magnitude(self):
        """The OSGB36 Helmert moves the grid ~60-140 m vs a null-datum
        projection of the same TM parameters."""
        lon, lat = np.array([-2.0]), np.array([52.0])
        e, n = transform_points(4326, 27700, lon, lat)
        null_tm = CRS(32767, ('tm', 'AIRY1830', 49.0, -2.0,
                              0.9996012717, 400000.0, -100000.0))
        e0, n0 = transform_points(4326, null_tm, lon, lat)
        d = float(np.hypot(e - e0, n - n0)[0])
        assert 60.0 < d < 200.0, d

    @pytest.mark.parametrize('epsg,lon_range,lat_range', [
        (27700, (-6, 1.5), (50, 58)),      # OSGB36 / BNG
        (23031, (0, 6), (36, 52)),         # ED50 / UTM 31N
        (26715, (-96, -90), (28, 48)),     # NAD27 / UTM 15N
        (28405, (24, 30), (42, 70)),       # Pulkovo 1942 / GK zone 5
        (4230, (-8, 10), (36, 60)),        # ED50 geographic
        (4277, (-6, 1.5), (50, 58)),       # OSGB36 geographic
        (4301, (128, 146), (30, 45)),      # Tokyo geographic
    ])
    def test_roundtrip_via_transform_points(self, epsg, lon_range,
                                            lat_range):
        rng = np.random.default_rng(epsg)
        lon = rng.uniform(*lon_range, 300)
        lat = rng.uniform(*lat_range, 300)
        x, y = transform_points(4326, epsg, lon, lat)
        lo, la = transform_points(epsg, 4326, x, y)
        assert np.abs(lo - lon).max() < 2e-7
        assert np.abs(la - lat).max() < 2e-7

    def test_ed50_utm_vs_wgs84_utm_offset(self):
        """ED50 UTM coordinates differ from WGS84 UTM of the same
        point by the classical ~100-250 m European datum offset."""
        lon, lat = np.array([3.0]), np.array([46.0])
        e50, n50 = transform_points(4326, 23031, lon, lat)
        e84, n84 = transform_points(4326, 32631, lon, lat)
        d = float(np.hypot(e50 - e84, n50 - n84)[0])
        assert 100.0 < d < 300.0, d

    @pytest.mark.parametrize('epsg', [
        27700, 23031, 26715, 28405, 4230, 4277, 4301, 4284, 4267])
    def test_wkt_proj4_roundtrip(self, epsg):
        crs = CRS.from_epsg(epsg)
        assert CRS.from_wkt(crs.to_wkt()) == crs
        p4 = CRS.from_proj4(crs.to_proj4())
        if p4 != crs:
            # functional equivalence is required where the proj4 text
            # cannot name the registry code (e.g. geographic datums)
            lon = np.array([(-2.0 if epsg in (27700, 4277, 26715,
                                              4267) else 9.0)])
            lat = np.array([52.0])
            a = transform_points(4326, crs, lon, lat)
            b = transform_points(4326, p4, lon, lat)
            assert np.allclose(a, b, atol=1e-9)

    def test_explicit_towgs84_overrides_registry(self):
        """A TOWGS84[0,0,0] in the file's WKT is the EXPLICIT null
        transformation and overrides the registry Helmert (the OSR
        contract: the SRS the file carries wins)."""
        wkt = CRS(27700).to_wkt()
        import re
        wkt_null = re.sub(r'TOWGS84\[[^\]]*\]', 'TOWGS84[0,0,0]', wkt)
        c = CRS.from_wkt(wkt_null)
        assert c.epsg == 27700
        assert c.towgs84 == (0.0,) * 7
        lon, lat = np.array([-2.0]), np.array([52.0])
        e, n = transform_points(4326, c, lon, lat)
        null_tm = CRS(32767, ('tm', 'AIRY1830', 49.0, -2.0,
                              0.9996012717, 400000.0, -100000.0))
        e0, n0 = transform_points(4326, null_tm, lon, lat)
        assert float(np.hypot(e - e0, n - n0)[0]) < 1e-9

    def test_custom_crs_towgs84_serialization(self):
        """User-defined CRS carry their TOWGS84 through WKT and proj4
        round-trips."""
        tw = (674.4, 15.1, 405.3, 1.0, -0.5, 2.0, 3.5)
        c = CRS(32767, ('tm', 'BESSEL1841', 0.0, 9.0, 1.0,
                        500000.0, 0.0), 1.0, tw)
        w = CRS.from_wkt(c.to_wkt())
        assert w == c, c.to_wkt()
        p = CRS.from_proj4(c.to_proj4())
        assert p.towgs84 == tw
        lon, lat = np.array([9.5]), np.array([47.0])
        assert np.allclose(transform_points(4326, c, lon, lat),
                           transform_points(4326, p, lon, lat),
                           atol=1e-9)

    def test_geog_family_proj4(self):
        """+proj=longlat on a classical ellipsoid with +towgs84: the
        datum shift applies between the geographic frames."""
        p4 = ('+proj=longlat +ellps=bessel '
              '+towgs84=-146.414,507.337,680.507 +no_defs')
        c = CRS.from_proj4(p4)
        assert c.is_geographic
        lon, lat = np.array([139.5]), np.array([35.7])
        lo, la = transform_points(4326, c, lon, lat)
        # same frame as the Tokyo registry code
        lo2, la2 = transform_points(4326, 4301, lon, lat)
        assert np.allclose([lo, la], [lo2, la2], atol=1e-12)
        # and the shift is the classical ~10 arc-second Tokyo offset
        assert 5.0 < abs(la[0] - lat[0]) * 3600 < 15.0
        rt = CRS.from_proj4(c.to_proj4())
        assert np.allclose(transform_points(4326, rt, lon, lat),
                           [lo, la], atol=1e-12)


class TestDatumTiffIntegration:
    def test_geokey_roundtrip_custom_towgs84(self, tmp_path):
        """A custom CRS with TOWGS84 written to GeoTIFF round-trips
        through the GeogTOWGS84GeoKey (2062, GeoTIFF 1.1)."""
        tw = (446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489)
        c = CRS(32767, ('tm', 'AIRY1830', 49.0, -2.0, 0.9996012717,
                        400000.0, -100000.0), 1.0, tw)
        path = str(tmp_path / 'datum.tif')
        write_cog(path, np.zeros((32, 32), np.uint8),
                  geotransform=(400000.0, 30.0, 0.0, 300000.0, 0.0,
                                -30.0),
                  epsg=c, overview_levels=())
        with TiffReader(path) as r:
            got = r.crs()
        assert got.towgs84 == tw
        assert got.custom == c.custom

    def test_registry_datum_code_roundtrip(self, tmp_path):
        path = str(tmp_path / 'ed50.tif')
        write_cog(path, np.zeros((16, 16), np.uint8),
                  geotransform=(500000.0, 30.0, 0.0, 4650000.0, 0.0,
                                -30.0),
                  epsg=23031, overview_levels=())
        with TiffReader(path) as r:
            got = r.crs()
        assert got == CRS(23031)
        assert got.datum_shift == (-87.0, -98.0, -121.0, 0.0, 0.0,
                                   0.0, 0.0)

    def test_datum_dem_warp_device_matches_host(self, tmp_path):
        """A DEM delivered in OSGB36 / British National Grid warped
        onto a WGS84 UTM 30N tile: accepted by the coverage check,
        datum shift applied, device warp bit-identical to host."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        rng = np.random.default_rng(1936)
        h = w = 300
        # around 52N 2W (BNG ~400000E 233500N)
        gt = (390000.0, 90.0, 0.0, 250000.0, 0.0, -90.0)
        arr = (200 + 50 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        path = str(tmp_path / 'bng_dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=27700,
                  nodata=float('nan'), overview_levels=())
        # UTM 30N tile over the same area (lon -2 => easting ~568000)
        tile_gt = (560000.0, 30.0, 0.0, 5770000.0, 0.0, -30.0)
        proj = 'EPSG:32630'
        check_ancillary_inputs(True, False, path, path, path, None,
                               tile_gt, proj, 100, 120, {})
        for alg in ('nearest', 'bilinear', 'cubic'):
            host = warp_to_grid(path, tile_gt, proj, 100, 120,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            nn = np.isnan(host)
            assert (~nn).any(), 'tile missed the BNG source'
            dev = np.asarray(warp_to_grid_device(
                path, tile_gt, proj, 100, 120, resample_algorithm=alg,
                margin_in_pixels=10))
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), f'{alg}: {bad.sum()} mismatches'
