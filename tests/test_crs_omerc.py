"""Hotine oblique Mercator (EPSG 9812/9815) and Swiss oblique Mercator
(somerc) tests.

These are the 'exotic method' OSR projections the reference reaches
through its any-SRS contract (dswx_hls.py:3385-3461): US State Plane
Alaska zone 1, the Borneo/Malaysia RSO grids, and the Swiss CH1903
LV03/LV95 grids — all plausible CRSs of a delivered DEM. Pinned to the
EPSG Guidance Note 7-2 Timbalai 1948 worked example and the published
swisstopo LV03 anchor.
"""

import numpy as np
import pytest

from proteus_jax.geo.crs import (
    CRS, omerc_forward, omerc_inverse, somerc_forward, somerc_inverse,
    transform_points)
from proteus_jax.geo.warp import warp_to_grid, warp_to_grid_device
from proteus_jax.io.cog import write_cog
from proteus_jax.io.tiff import TiffReader


def _dms(d, m, s):
    return d + m / 60.0 + s / 3600.0


TIMBALAI = ('EVEREST1967', 4.0, 115.0, _dms(53, 18, 56.9537),
            _dms(53, 7, 48.3685), 0.99984, 590476.87, 442857.65, True)
ALASKA1 = ('GRS80', 57.0, -(133.0 + 40.0 / 60),
           -_dms(36, 52, 11.6315), -_dms(36, 52, 11.6315),
           0.9999, 5000000.0, -5000000.0, False)
SWISS = ('BESSEL1841', _dms(46, 57, 8.66), _dms(7, 26, 22.50),
         1.0, 600000.0, 200000.0)


class TestHotineObliqueMercator:
    def test_epsg_guidance_note_timbalai_example(self):
        """EPSG GN7-2 worked example, Timbalai 1948 / RSO Borneo (m),
        variant B: 5°23'14.1129"N 115°48'19.8196"E ->
        E 679245.73, N 596562.78."""
        lat, lon = _dms(5, 23, 14.1129), _dms(115, 48, 19.8196)
        E, N = omerc_forward(lat, lon, *TIMBALAI)
        assert abs(E - 679245.73) < 0.01
        assert abs(N - 596562.78) < 0.01
        # the published E/N are rounded to cm, so the inverse agrees
        # to the corresponding ~1e-7 degrees
        la, lo = omerc_inverse(679245.73, 596562.78, *TIMBALAI)
        assert abs(la - lat) < 1e-7 and abs(lo - lon) < 1e-7

    @pytest.mark.parametrize('args,lon_range,lat_range', [
        (TIMBALAI, (109, 120), (0.5, 8)),
        (ALASKA1, (-142, -128), (54, 62)),
    ])
    def test_roundtrip(self, args, lon_range, lat_range):
        rng = np.random.default_rng(9815)
        lat = rng.uniform(*lat_range, 500)
        lon = rng.uniform(*lon_range, 500)
        E, N = omerc_forward(lat, lon, *args)
        la, lo = omerc_inverse(E, N, *args)
        assert np.abs(la - lat).max() < 1e-11
        assert np.abs(lo - lon).max() < 1e-11

    def test_variant_a_b_constant_offset(self):
        """Variants A and B of the same projection differ by the
        constant (uc sin(gamma_c), uc cos(gamma_c)) grid shift."""
        args_a = TIMBALAI[:-1] + (False,)
        rng = np.random.default_rng(1)
        lat = rng.uniform(1, 7, 50)
        lon = rng.uniform(110, 119, 50)
        Eb, Nb = omerc_forward(lat, lon, *TIMBALAI)
        Ea, Na = omerc_forward(lat, lon, *args_a)
        de, dn = Ea - Eb, Na - Nb
        assert np.ptp(de) < 1e-6 and np.ptp(dn) < 1e-6
        # the offset is |uc| resolved through the rectified grid angle
        gam = np.radians(TIMBALAI[4])
        uc = np.hypot(de[0], dn[0])
        assert abs(de[0] - uc * np.sin(gam)) < 1e-6
        assert abs(dn[0] - uc * np.cos(gam)) < 1e-6

    def test_conformality(self):
        """Scale is isotropic (conformal projection): the forward
        differentials at any point form a similarity transform."""
        for args, lat, lon in ((TIMBALAI, 5.0, 116.0),
                               (ALASKA1, 58.0, -135.0)):
            d = 1e-7
            E0, N0 = omerc_forward(lat, lon, *args)
            E1, N1 = omerc_forward(lat + d, lon, *args)
            E2, N2 = omerc_forward(lat, lon + d, *args)
            va = np.array([E1 - E0, N1 - N0])
            vb = np.array([E2 - E0, N2 - N0])
            # orthogonal and |va|/|vb| = dlat-metres / dlon-metres
            cosang = va @ vb / (np.linalg.norm(va)
                                * np.linalg.norm(vb))
            assert abs(cosang) < 1e-5

    def test_azimuth_90_rejected_as_omerc(self):
        with pytest.raises(ValueError, match='somerc'):
            omerc_forward(46.0, 7.0, 'BESSEL1841', 46.95, 7.44,
                          90.0, 90.0, 1.0, 0.0, 0.0, True)


class TestSwissObliqueMercator:
    def test_projection_center_is_false_origin(self):
        E, N = somerc_forward(SWISS[1], SWISS[2], *SWISS)
        assert abs(E - 600000.0) < 1e-6
        assert abs(N - 200000.0) < 1e-5

    def test_swisstopo_anchor(self):
        """swisstopo reference point: WGS84 46.04412093N 8.730497076E
        = LV03 (700000, 100000); the parametric CH1903 Helmert is
        quoted at 1-2 m vs the official grid transform."""
        e, n = transform_points(4326, 21781,
                                np.array([8.730497076]),
                                np.array([46.04412093]))
        assert np.hypot(e[0] - 700000.0, n[0] - 100000.0) < 2.0

    def test_lv95_offset(self):
        """LV95 (EPSG:2056) = LV03 + (2000000, 1000000) exactly."""
        lon = np.array([7.8, 9.2])
        lat = np.array([46.3, 47.2])
        e03, n03 = transform_points(4326, 21781, lon, lat)
        e95, n95 = transform_points(4326, 2056, lon, lat)
        # the two codes differ only in FE/FN (datum shifts differ by
        # centimetres between CH1903 and CH1903+)
        assert np.abs(e95 - 2000000.0 - e03).max() < 0.1
        assert np.abs(n95 - 1000000.0 - n03).max() < 0.1

    def test_roundtrip(self):
        rng = np.random.default_rng(21781)
        lat = rng.uniform(45.8, 47.8, 500)
        lon = rng.uniform(6.0, 10.5, 500)
        E, N = somerc_forward(lat, lon, *SWISS)
        la, lo = somerc_inverse(E, N, *SWISS)
        assert np.abs(la - lat).max() < 1e-11
        assert np.abs(lo - lon).max() < 1e-11

    def test_conformality(self):
        d = 1e-7
        E0, N0 = somerc_forward(46.5, 8.0, *SWISS)
        E1, N1 = somerc_forward(46.5 + d, 8.0, *SWISS)
        E2, N2 = somerc_forward(46.5, 8.0 + d, *SWISS)
        va = np.array([E1 - E0, N1 - N0])
        vb = np.array([E2 - E0, N2 - N0])
        cosang = va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb))
        assert abs(cosang) < 1e-5


class TestKrovak:
    """S-JTSK / Krovak East North (EPSG:5514) — the Czech/Slovak
    national grid (EPSG method 9819, east-north axis convention)."""

    ARGS = ('BESSEL1841', 49.5, _dms(24, 50, 0),
            _dms(30, 17, 17.3031), 78.5, 0.9999, 0.0, 0.0)

    def test_epsg_guidance_note_example(self):
        """EPSG GN7-2 Krovak worked example: 50°12'32.4416"N
        16°50'59.1790"E -> southing 1050538.64, westing 568991.00
        (east-north: E = -568991.00, N = -1050538.64)."""
        from proteus_jax.geo.crs import krovak_forward, krovak_inverse
        lat, lon = _dms(50, 12, 32.4416), _dms(16, 50, 59.1790)
        E, N = krovak_forward(lat, lon, *self.ARGS)
        assert abs(-E - 568991.00) < 0.02
        assert abs(-N - 1050538.64) < 0.02
        la, lo = krovak_inverse(E, N, *self.ARGS)
        assert abs(la - lat) < 1e-11 and abs(lo - lon) < 1e-11

    def test_roundtrip_and_conformality(self):
        from proteus_jax.geo.crs import krovak_forward, krovak_inverse
        rng = np.random.default_rng(5514)
        lat = rng.uniform(47.8, 51.2, 500)
        lon = rng.uniform(12.0, 22.5, 500)
        E, N = krovak_forward(lat, lon, *self.ARGS)
        la, lo = krovak_inverse(E, N, *self.ARGS)
        assert np.abs(la - lat).max() < 1e-11
        assert np.abs(lo - lon).max() < 1e-11
        d = 1e-7
        E0, N0 = krovak_forward(50.0, 15.0, *self.ARGS)
        E1, N1 = krovak_forward(50.0 + d, 15.0, *self.ARGS)
        E2, N2 = krovak_forward(50.0, 15.0 + d, *self.ARGS)
        va = np.array([E1 - E0, N1 - N0])
        vb = np.array([E2 - E0, N2 - N0])
        cosang = va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb))
        assert abs(cosang) < 1e-5

    def test_registry_crs_with_datum(self):
        """EPSG:5514 through transform_points applies the S-JTSK
        Helmert (EPSG tx 1623): Prague lands at its known grid
        coordinates."""
        c = CRS(5514)
        assert CRS.from_wkt(c.to_wkt()) == c
        assert CRS.from_proj4(c.to_proj4()) == c
        e, n = transform_points(4326, 5514, np.array([14.421]),
                                np.array([50.0875]))
        # Prague centre: E ~ -742.8 km, N ~ -1043.0 km
        assert abs(e[0] + 742833.0) < 200.0
        assert abs(n[0] + 1043014.0) < 200.0
        lo, la = transform_points(5514, 4326, e, n)
        assert abs(lo[0] - 14.421) < 2e-7
        assert abs(la[0] - 50.0875) < 2e-7

    def test_krovak_dem_warp_host(self, tmp_path):
        """A DEM in EPSG:5514 warps onto a UTM 33N tile through the
        full Krovak + Helmert chain."""
        rng = np.random.default_rng(9819)
        h = w = 200
        # around Prague: 5514 coords are negative east/north
        gt = (-752000.0, 90.0, 0.0, -1034000.0, 0.0, -90.0)
        arr = (300 + 80 * rng.normal(size=(h, w))).astype(np.float32)
        path = str(tmp_path / 'sjtsk_dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=5514,
                  nodata=float('nan'), overview_levels=())
        eu, nu = transform_points(4326, 32633, np.array([14.42]),
                                  np.array([50.08]))
        tile_gt = (float(eu[0]) - 1500.0, 30.0, 0.0,
                   float(nu[0]) + 1800.0, 0.0, -30.0)
        host = warp_to_grid(path, tile_gt, 'EPSG:32633', 100, 120,
                            resample_algorithm='cubic',
                            margin_in_pixels=10)
        assert np.isfinite(host).any(), 'tile missed the 5514 source'


class TestObliqueMercatorCrsPlumbing:
    @pytest.mark.parametrize('epsg', [29873, 26931, 21781, 2056])
    def test_wkt_proj4_identity_roundtrip(self, epsg):
        crs = CRS(epsg)
        assert CRS.from_wkt(crs.to_wkt()) == crs
        assert CRS.from_proj4(crs.to_proj4()) == crs

    def test_custom_omerc_geokey_roundtrip(self, tmp_path):
        for vb in (False, True):
            c = CRS(32767, ('omerc', 'EVEREST1967', 4.0, 115.0,
                            53.31582047222222, 53.13010236111111,
                            0.99984, 590476.87, 442857.65, vb))
            path = str(tmp_path / f'om_{vb}.tif')
            write_cog(path, np.zeros((16, 16), np.uint8),
                      geotransform=(600000.0, 30.0, 0.0, 600000.0,
                                    0.0, -30.0),
                      epsg=c, overview_levels=())
            with TiffReader(path) as r:
                got = r.crs()
            assert got.custom == c.custom, (vb, got.custom)

    def test_custom_somerc_geokey_roundtrip(self, tmp_path):
        c = CRS(32767, ('somerc', 'BESSEL1841', 46.95240555555556,
                        7.439583333333333, 1.0, 600000.0, 200000.0))
        path = str(tmp_path / 'som.tif')
        write_cog(path, np.zeros((16, 16), np.uint8),
                  geotransform=(600000.0, 30.0, 0.0, 220000.0,
                                0.0, -30.0),
                  epsg=c, overview_levels=())
        with TiffReader(path) as r:
            got = r.crs()
        assert got.custom == c.custom

    def test_gdal_style_hom_ac_azimuth90_wkt_is_somerc(self):
        """GDAL encodes the Swiss grids as Hotine azimuth-center with
        azimuth = rectified grid angle = 90; that WKT must resolve to
        the somerc math (the PROJ/GDAL convention)."""
        wkt = ('PROJCS["CH1903 / LV03",GEOGCS["CH1903",'
               'DATUM["CH1903",SPHEROID["Bessel 1841",6377397.155,'
               '299.1528128],TOWGS84[674.4,15.1,405.3,0,0,0,0]],'
               'PRIMEM["Greenwich",0],'
               'UNIT["degree",0.0174532925199433]],'
               'PROJECTION["Hotine_Oblique_Mercator_Azimuth_Center"],'
               'PARAMETER["latitude_of_center",46.9524055555556],'
               'PARAMETER["longitude_of_center",7.43958333333333],'
               'PARAMETER["azimuth",90],'
               'PARAMETER["rectified_grid_angle",90],'
               'PARAMETER["scale_factor",1],'
               'PARAMETER["false_easting",600000],'
               'PARAMETER["false_northing",200000],UNIT["metre",1]]')
        c = CRS.from_wkt(wkt)
        assert c.custom is not None and c.custom[0] == 'somerc'
        lon = np.array([8.730497076])
        lat = np.array([46.04412093])
        e, n = transform_points(4326, c, lon, lat)
        assert np.hypot(e[0] - 700000.0, n[0] - 100000.0) < 2.0

    def test_laborde_rejected(self):
        wkt = ('PROJCS["x",GEOGCS["unknown",DATUM["unknown",'
               'SPHEROID["intl",6378388,297]],PRIMEM["Greenwich",0],'
               'UNIT["degree",0.0174532925199433]],'
               'PROJECTION["Oblique_Mercator_Laborde"],'
               'PARAMETER["azimuth",18.9],UNIT["metre",1]]')
        with pytest.raises(ValueError):
            CRS.from_wkt(wkt)

    def test_alaska_dem_warp_device_matches_host(self, tmp_path):
        """A DEM delivered in NAD83 / Alaska zone 1 (Hotine variant A)
        warped onto a WGS84 UTM 8N tile: accepted by the coverage
        check, device warp bit-identical to host."""
        from proteus_jax.geo.coverage import check_ancillary_inputs
        rng = np.random.default_rng(26931)
        h = w = 300
        # around 58N 135W: EPSG:26931 coords
        e0, n0 = transform_points(4326, 26931, np.array([-135.0]),
                                  np.array([58.0]))
        gt = (float(e0[0]) - 13500.0, 90.0, 0.0,
              float(n0[0]) + 13500.0, 0.0, -90.0)
        arr = (800 + 200 * rng.normal(size=(h, w))).astype(np.float32)
        arr[rng.random((h, w)) < 0.03] = np.nan
        path = str(tmp_path / 'ak_dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=26931,
                  nodata=float('nan'), overview_levels=())
        eu, nu = transform_points(4326, 32608, np.array([-135.0]),
                                  np.array([58.0]))
        tile_gt = (float(eu[0]) - 1500.0, 30.0, 0.0,
                   float(nu[0]) + 1800.0, 0.0, -30.0)
        proj = 'EPSG:32608'
        check_ancillary_inputs(True, False, path, path, path, None,
                               tile_gt, proj, 100, 120, {})
        for alg in ('nearest', 'bilinear', 'cubic'):
            host = warp_to_grid(path, tile_gt, proj, 100, 120,
                                resample_algorithm=alg,
                                margin_in_pixels=10)
            nn = np.isnan(host)
            assert (~nn).any(), 'tile missed the Alaska source'
            dev = np.asarray(warp_to_grid_device(
                path, tile_gt, proj, 100, 120, resample_algorithm=alg,
                margin_in_pixels=10))
            bad = (host != dev) & ~(nn & np.isnan(dev))
            assert not bad.any(), f'{alg}: {bad.sum()} mismatches'

    def test_swiss_dem_warp_host(self, tmp_path):
        """A DEM in CH1903 / LV03 warps onto a UTM 32N tile through
        the full datum chain (Bessel + Helmert + somerc)."""
        rng = np.random.default_rng(1903)
        h = w = 200
        gt = (690000.0, 90.0, 0.0, 110000.0, 0.0, -90.0)
        arr = (1500 + 300 * rng.normal(size=(h, w))).astype(np.float32)
        path = str(tmp_path / 'lv03_dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=21781,
                  nodata=float('nan'), overview_levels=())
        eu, nu = transform_points(4326, 32632, np.array([8.73]),
                                  np.array([46.05]))
        tile_gt = (float(eu[0]) - 1500.0, 30.0, 0.0,
                   float(nu[0]) + 1800.0, 0.0, -30.0)
        host = warp_to_grid(path, tile_gt, 'EPSG:32632', 100, 120,
                            resample_algorithm='cubic',
                            margin_in_pixels=10)
        assert np.isfinite(host).any(), 'tile missed the LV03 source'
