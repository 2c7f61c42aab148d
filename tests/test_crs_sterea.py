"""Oblique Stereographic (EPSG 9809) and Equidistant Cylindrical
(EPSG 1028) tests, plus the NZTM registry entry.

More 'any OSR-resolvable SRS' coverage (reference contract at
dswx_hls.py:3385-3461): the Dutch RD New grid (EPSG:28992) is the
plausible CRS of a Dutch DEM/ancillary delivery; EPSG:4087/32662 world
equidistant cylindrical turns up on global rasters; NZGD2000 / NZTM
(EPSG:2193) on New Zealand deliveries. Pinned to the EPSG Guidance
Note 7-2 worked examples.
"""

import numpy as np
import pytest

from proteus_jax.geo.crs import (
    CRS, sterea_forward, sterea_inverse, eqc_forward, eqc_inverse,
    transform_points)
from proteus_jax.geo.warp import warp_to_grid
from proteus_jax.io.cog import write_cog
from proteus_jax.io.tiff import TiffReader


def _dms(d, m, s):
    return d + m / 60.0 + s / 3600.0


RD_NEW = ('BESSEL1841', _dms(52, 9, 22.178), _dms(5, 23, 15.5),
          0.9999079, 155000.0, 463000.0)


class TestObliqueStereographic:
    def test_epsg_guidance_note_rd_example(self):
        """EPSG GN7-2 worked example, Amersfoort / RD New: 53°N 6°E ->
        E 196105.283, N 557057.739."""
        E, N = sterea_forward(53.0, 6.0, *RD_NEW)
        assert abs(E - 196105.283) < 0.005
        assert abs(N - 557057.739) < 0.005
        la, lo = sterea_inverse(196105.283, 557057.739, *RD_NEW)
        assert abs(la - 53.0) < 1e-7 and abs(lo - 6.0) < 1e-7

    def test_roundtrip_and_conformality(self):
        rng = np.random.default_rng(9809)
        lat = rng.uniform(50.5, 53.8, 500)
        lon = rng.uniform(3.2, 7.3, 500)
        E, N = sterea_forward(lat, lon, *RD_NEW)
        la, lo = sterea_inverse(E, N, *RD_NEW)
        assert np.abs(la - lat).max() < 1e-11
        assert np.abs(lo - lon).max() < 1e-11
        # conformal: meridian/parallel images stay orthogonal
        d = 1e-7
        E0, N0 = sterea_forward(52.0, 5.0, *RD_NEW)
        E1, N1 = sterea_forward(52.0 + d, 5.0, *RD_NEW)
        E2, N2 = sterea_forward(52.0, 5.0 + d, *RD_NEW)
        va = np.array([E1 - E0, N1 - N0])
        vb = np.array([E2 - E0, N2 - N0])
        cosang = va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb))
        assert abs(cosang) < 1e-5

    def test_registry_crs_with_datum(self):
        """EPSG:28992 applies the Amersfoort Helmert: the OLV tower
        (the RD origin) lands at the false origin."""
        c = CRS(28992)
        assert CRS.from_wkt(c.to_wkt()) == c
        assert CRS.from_proj4(c.to_proj4()) == c
        e, n = transform_points(4326, 28992, np.array([5.387206]),
                                np.array([52.155172]))
        assert abs(e[0] - 155000.0) < 2.0
        assert abs(n[0] - 463000.0) < 2.0
        lo, la = transform_points(28992, 4326, e, n)
        assert abs(lo[0] - 5.387206) < 2e-7
        assert abs(la[0] - 52.155172) < 2e-7

    def test_custom_sterea_geokey_roundtrip(self, tmp_path):
        c = CRS(32767, ('sterea', 'BESSEL1841', 52.15616055555555,
                        5.3876388888888895, 0.9999079, 155000.0,
                        463000.0))
        path = str(tmp_path / 'sterea.tif')
        write_cog(path, np.zeros((16, 16), np.uint8),
                  geotransform=(150000.0, 30.0, 0.0, 470000.0,
                                0.0, -30.0),
                  epsg=c, overview_levels=())
        with TiffReader(path) as r:
            got = r.crs()
        assert got.custom == c.custom

    def test_rd_dem_warp_host(self, tmp_path):
        """A DEM in EPSG:28992 warps onto a UTM 31N tile through the
        full sterea + Helmert chain."""
        rng = np.random.default_rng(28992)
        h = w = 200
        # around Amsterdam (RD ~ 121000 E, 487000 N)
        gt = (113000.0, 90.0, 0.0, 496000.0, 0.0, -90.0)
        arr = (2 + 5 * rng.normal(size=(h, w))).astype(np.float32)
        path = str(tmp_path / 'rd_dem.tif')
        write_cog(path, arr, geotransform=gt, epsg=28992,
                  nodata=float('nan'), overview_levels=())
        eu, nu = transform_points(4326, 32631, np.array([4.9]),
                                  np.array([52.37]))
        tile_gt = (float(eu[0]) - 1500.0, 30.0, 0.0,
                   float(nu[0]) + 1800.0, 0.0, -30.0)
        host = warp_to_grid(path, tile_gt, 'EPSG:32631', 100, 120,
                            resample_algorithm='cubic',
                            margin_in_pixels=10)
        assert np.isfinite(host).any(), 'tile missed the RD source'


class TestEquidistantCylindrical:
    def test_epsg_guidance_note_example(self):
        """EPSG GN7-2 worked example (method 1028, WGS 84): 55°N 10°E
        -> E 1113194.91, N 6097230.3131."""
        E, N = eqc_forward(55.0, 10.0, 'WGS84', 0.0, 0.0, 0.0,
                           0.0, 0.0)
        assert abs(E - 1113194.91) < 0.01
        assert abs(N - 6097230.3131) < 0.005
        la, lo = eqc_inverse(E, N, 'WGS84', 0.0, 0.0, 0.0, 0.0, 0.0)
        assert abs(la - 55.0) < 1e-11 and abs(lo - 10.0) < 1e-11

    def test_roundtrip_nonzero_params(self):
        rng = np.random.default_rng(1028)
        args = ('GRS80', 30.0, 10.0, 45.0, 100000.0, -50000.0)
        lat = rng.uniform(-85, 85, 500)
        lon = rng.uniform(-130, 220, 500)
        E, N = eqc_forward(lat, lon, *args)
        la, lo = eqc_inverse(E, N, *args)
        assert np.abs(la - lat).max() < 1e-11
        # lon wraps into (-180, 180]
        want = (lon + 180.0) % 360.0 - 180.0
        assert np.abs(lo - want).max() < 1e-11

    @pytest.mark.parametrize('epsg', [4087, 32662])
    def test_registry_roundtrip(self, epsg):
        c = CRS(epsg)
        assert CRS.from_wkt(c.to_wkt()).general == c.general
        assert CRS.from_proj4(c.to_proj4()).general == c.general
        # world grid: the equator is true to scale
        e, n = transform_points(4326, epsg, np.array([10.0]),
                                np.array([0.0]))
        assert abs(e[0] - 1113194.9079327343) < 1e-6
        assert abs(n[0]) < 1e-9

    def test_custom_eqc_geokey_roundtrip(self, tmp_path):
        c = CRS(32767, ('eqc', 'WGS84', 30.0, 0.0, 15.0, 0.0, 0.0))
        path = str(tmp_path / 'eqc.tif')
        write_cog(path, np.zeros((16, 16), np.uint8),
                  geotransform=(0.0, 1000.0, 0.0, 5000000.0,
                                0.0, -1000.0),
                  epsg=c, overview_levels=())
        with TiffReader(path) as r:
            got = r.crs()
        assert got.custom == c.custom

    def test_world_eqc_source_warp_host(self, tmp_path):
        """A global ancillary raster in EPSG:4087 warps onto a UTM
        tile."""
        rng = np.random.default_rng(4087)
        h, w = 120, 240
        # 1.5-degree pixels covering the world
        scale = 111319.49079327343 * 1.5
        gt = (-20037508.34, scale, 0.0, 10018754.17, 0.0, -scale)
        arr = rng.integers(0, 200, (h, w)).astype(np.uint8)
        path = str(tmp_path / 'world_eqc.tif')
        write_cog(path, arr, geotransform=gt, epsg=4087,
                  overview_levels=())
        host = warp_to_grid(path, (399960.0, 30.0, 0.0, 5600040.0,
                                   0.0, -30.0),
                            'EPSG:32631', 64, 64,
                            resample_algorithm='nearest')
        assert np.isfinite(host).all()


class TestNztmRegistry:
    def test_registry_roundtrip_and_anchor(self):
        """EPSG:2193 (NZGD2000 / NZTM): Wellington-area anchor. The
        km-scale tolerance pins the grid PARAMETERS (a wrong lon0/FE/FN
        would miss by 10-1000 km); the TM math itself is exercised
        exactly by the UTM/BNG worked-example tests."""
        c = CRS(2193)
        assert CRS.from_wkt(c.to_wkt()) == c
        # proj4 round-trips to the equivalent custom TM (the tmerc
        # parser deliberately does not identify registry grids; NZGD2000
        # is a null shift so the transforms are identical)
        back = CRS.from_proj4(c.to_proj4())
        assert back.custom == c.general and back.datum_shift is None
        e, n = transform_points(4326, 2193, np.array([174.7772]),
                                np.array([-41.2889]))
        assert abs(e[0] - 1748735.0) < 1000.0
        assert abs(n[0] - 5427869.0) < 1000.0
        lo, la = transform_points(2193, 4326, e, n)
        assert abs(lo[0] - 174.7772) < 1e-9
        assert abs(la[0] + 41.2889) < 1e-9
