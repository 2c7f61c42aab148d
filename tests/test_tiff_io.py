"""GeoTIFF/COG codec round-trip tests."""

import glob

import numpy as np
import pytest

from proteus_jax.io import codecs
from proteus_jax.io.cog import write_cog
from proteus_jax.io.tiff import TiffReader
from proteus_jax.io.validate_cog import validate_cog

RNG = np.random.default_rng(3)


class TestCodecs:
    def test_packbits_roundtrip(self):
        data = bytes(RNG.integers(0, 4, 1000).astype(np.uint8))
        assert codecs.packbits_decode(codecs.packbits_encode(data)) == data

    def test_lzw_roundtrip(self):
        data = bytes(RNG.integers(0, 16, 5000).astype(np.uint8))
        assert codecs.lzw_decode(codecs.lzw_encode(data)) == data

    def test_lzw_long_roundtrip(self):
        # long enough to exercise width bumps and table overflow/clear
        data = bytes(RNG.integers(0, 255, 200_000).astype(np.uint8))
        assert codecs.lzw_decode(codecs.lzw_encode(data)) == data

    def test_horizontal_predictor_roundtrip(self):
        for dtype in (np.uint8, np.uint16, np.int16):
            arr = RNG.integers(np.iinfo(dtype).min, np.iinfo(dtype).max,
                               (16, 32, 3)).astype(dtype)
            enc = codecs.predict_horizontal(arr)
            dec = codecs.unpredict_horizontal(enc, 3)
            np.testing.assert_array_equal(dec, arr)

    def test_deflate_roundtrip_levels(self):
        # libdeflate when present, zlib otherwise; either way the streams
        # are standard zlib format and interchangeable
        import zlib
        data = RNG.integers(0, 255, 300_000).astype(np.uint8).tobytes()
        for level in (1, 6, 9):
            enc = codecs.deflate_encode(data, level)
            assert zlib.decompress(enc) == data
            assert codecs.deflate_decode(enc, len(data)) == data
        # zlib-produced stream decodes through our decoder too
        assert codecs.deflate_decode(zlib.compress(data, 6), len(data)) \
            == data

    def test_float_predictor_roundtrip(self):
        arr = RNG.normal(size=(8, 16, 1)).astype(np.float32)
        be = np.ascontiguousarray(
            arr.astype(arr.dtype.newbyteorder('>'))).tobytes()
        enc = codecs.predict_float(be, 8, 16, 1, 4)
        dec = codecs.unpredict_float(enc, 8, 16, 1, 4)
        got = np.frombuffer(dec, dtype='>f4').astype(np.float32)
        np.testing.assert_array_equal(got.reshape(8, 16), arr[:, :, 0])


class TestCogRoundtrip:
    @pytest.mark.parametrize('dtype,nodata', [
        (np.uint8, 255), (np.uint16, 65535), (np.int16, -9999),
        (np.float32, float('nan'))])
    def test_single_band(self, tmp_path, dtype, nodata):
        if np.dtype(dtype).kind == 'f':
            arr = RNG.normal(size=(700, 650)).astype(dtype)
        else:
            info = np.iinfo(dtype)
            arr = RNG.integers(info.min, info.max, (700, 650)).astype(dtype)
        path = str(tmp_path / 'x.tif')
        gt = (600000.0, 30.0, 0.0, 4300020.0, 0.0, -30.0)
        write_cog(path, arr, geotransform=gt, epsg=32615, nodata=nodata,
                  metadata={'PRODUCT_ID': 'test', 'K': 'v & <x>'},
                  band_descriptions={0: 'Water classification (WTR)'})
        with TiffReader(path) as r:
            got = r.read()
            np.testing.assert_array_equal(got, arr)
            assert r.geotransform() == pytest.approx(gt)
            assert r.epsg() == 32615
            nd = r.nodata()
            if isinstance(nodata, float) and np.isnan(nodata):
                assert np.isnan(nd)
            else:
                assert nd == nodata
            assert r.metadata()['PRODUCT_ID'] == 'test'
            assert r.metadata()['K'] == 'v & <x>'
            assert r.band_descriptions()[0] == \
                'Water classification (WTR)'
            assert len(r.overviews) >= 1
        assert validate_cog(path) == []

    def test_multiband(self, tmp_path):
        arr = RNG.integers(0, 255, (600, 580, 10)).astype(np.uint8)
        path = str(tmp_path / 'mb.tif')
        write_cog(path, arr, geotransform=(0, 30, 0, 0, 0, -30),
                  epsg=32601, nodata=255)
        with TiffReader(path) as r:
            got = r.read()
            np.testing.assert_array_equal(got, arr)
            assert r.count == 10
        assert validate_cog(path) == []

    def test_window_read(self, tmp_path):
        arr = RNG.integers(0, 60000, (1300, 1200)).astype(np.uint16)
        path = str(tmp_path / 'w.tif')
        write_cog(path, arr, epsg=4326)
        with TiffReader(path) as r:
            got = r.read(window=(100, 200, 1000, 1000))
            np.testing.assert_array_equal(got, arr[100:1100, 200:1200])
            # window clipped at the edge
            got = r.read(window=(1200, 1100, 1000, 1000))
            np.testing.assert_array_equal(got, arr[1200:, 1100:])

    def test_palette(self, tmp_path):
        arr = RNG.integers(0, 5, (520, 520)).astype(np.uint8)
        cmap = {0: (255, 255, 255), 1: (0, 0, 255), 2: (180, 213, 244),
                254: (0, 0, 127), 255: (0, 0, 0)}
        path = str(tmp_path / 'p.tif')
        write_cog(path, arr, epsg=32601, color_map=cmap)
        with TiffReader(path) as r:
            got_cmap = r.color_map()
            for k, v in cmap.items():
                assert got_cmap[k] == v
            np.testing.assert_array_equal(r.read(), arr)

    def test_overview_decimation(self, tmp_path):
        arr = np.arange(512 * 512, dtype=np.uint16).reshape(512, 512)
        path = str(tmp_path / 'o.tif')
        write_cog(path, arr, epsg=32601)
        with TiffReader(path) as r:
            assert [o.width for o in r.overviews] == [128, 32, 8, 4]
            ov = r.read(ifd_index=1)
            assert ov.shape == (128, 128)

    def test_cubicspline_float_overviews(self, tmp_path):
        from proteus_jax.io.cog import _cubicspline_decimate
        # constants are preserved exactly by the normalized B-spline kernel
        const = np.full((130, 97), 3.5, np.float32)
        for f in (4, 16, 64):
            d = _cubicspline_decimate(const, f)
            assert d.shape == ((130 + f - 1) // f, (97 + f - 1) // f)
            np.testing.assert_allclose(d, 3.5, atol=1e-6)
        # a linear ramp decimates to a linear ramp (B-spline reproduces
        # affine signals away from the truncated edge windows)
        ramp = np.tile(np.arange(400, dtype=np.float32), (16, 1))
        d = _cubicspline_decimate(ramp, 4)
        steps = np.diff(d[0, 2:-2])
        np.testing.assert_allclose(steps, 4.0, atol=1e-4)
        # float COG carries cubicspline overviews end-to-end
        arr = RNG.normal(100, 10, (512, 512)).astype(np.float32)
        path = str(tmp_path / 'f.tif')
        write_cog(path, arr, epsg=32601)
        with TiffReader(path) as r:
            ov = r.read(ifd_index=1)
        np.testing.assert_allclose(
            ov, _cubicspline_decimate(arr, 4), rtol=1e-6)

    def test_ghost_bytes_and_validator(self, tmp_path):
        """GDAL structural ghost area + block leader/trailer bytes
        (reference validator extern/validate_cloud_optimized_geotiff.py:
        82-95,196-214)."""
        from proteus_jax.io.validate_cog import validate_cog
        arr = RNG.integers(0, 255, (700, 600)).astype(np.uint8)
        path = str(tmp_path / 'g.tif')
        write_cog(path, arr, epsg=32601)
        raw = open(path, 'rb').read()
        assert raw[8:38].startswith(b'GDAL_STRUCTURAL_METADATA_SIZE=')
        assert b'BLOCK_LEADER=SIZE_AS_UINT4' in raw[:400]
        assert b'BLOCK_TRAILER=LAST_4_BYTES_REPEATED' in raw[:400]
        assert validate_cog(path, full_check=True) == []

        # corrupt one tile's leader -> the full check must catch it
        with TiffReader(path) as r:
            off = r.main.get(324)[0]  # first tile offset
        bad = bytearray(raw)
        bad[off - 4:off] = (123456).to_bytes(4, 'little')
        bad_path = str(tmp_path / 'bad.tif')
        open(bad_path, 'wb').write(bytes(bad))
        errs = validate_cog(bad_path, full_check=True)
        assert any('leader size' in e for e in errs)

        # corrupt a trailer
        with TiffReader(path) as r:
            cnt = r.main.get(325)[0]
        bad = bytearray(raw)
        bad[off + cnt:off + cnt + 4] = b'\xde\xad\xbe\xef'
        open(bad_path, 'wb').write(bytes(bad))
        errs = validate_cog(bad_path, full_check=True)
        assert any('trailer bytes' in e for e in errs)

    def test_uncompressed(self, tmp_path):
        arr = RNG.integers(0, 255, (100, 100)).astype(np.uint8)
        path = str(tmp_path / 'u.tif')
        write_cog(path, arr, epsg=32601, compress=False,
                  overview_levels=())
        with TiffReader(path) as r:
            np.testing.assert_array_equal(r.read(), arr)

    def test_geographic_epsg(self, tmp_path):
        arr = np.zeros((64, 64), np.uint8)
        path = str(tmp_path / 'g.tif')
        write_cog(path, arr, epsg=4326, overview_levels=())
        with TiffReader(path) as r:
            assert r.epsg() == 4326


def test_compare_handles_nan_rgb(tmp_path):
    """float32 RGB products with NaN fill compare equal (equal_nan), and
    differing pixels are detected."""
    from proteus_jax.runtime.compare import compare_dswx_hls_products
    rgb = RNG.normal(0.1, 0.02, (64, 64, 3)).astype(np.float32)
    rgb[:8, :8, :] = np.nan
    a = str(tmp_path / 'a.tif')
    b = str(tmp_path / 'b.tif')
    write_cog(a, rgb, epsg=32615, overview_levels=())
    write_cog(b, rgb, epsg=32615, overview_levels=())
    assert compare_dswx_hls_products(a, b)
    rgb2 = rgb.copy()
    rgb2[30, 30, 1] += 0.5
    c = str(tmp_path / 'c.tif')
    write_cog(c, rgb2, epsg=32615, overview_levels=())
    assert not compare_dswx_hls_products(a, c)


def test_sparse_tiles_read_as_zeros(tmp_path):
    """Blocks with zero offset/count (GDAL sparse files) decode as
    zeros."""
    import struct
    from proteus_jax.io.tiff import (TAG_TILE_OFFSETS,
                                     TAG_TILE_BYTE_COUNTS)
    arr = np.zeros((1024, 1024), np.uint8)
    arr[:512, :512] = 7
    path = str(tmp_path / 's.tif')
    write_cog(path, arr, epsg=32615, overview_levels=(),
              compress=False)
    with TiffReader(path) as r:
        # simulate sparseness by zeroing one tile's count in the parsed
        # IFD and re-reading
        counts = list(r.main.tags[TAG_TILE_BYTE_COUNTS])
        counts[3] = 0
        r.main.tags[TAG_TILE_BYTE_COUNTS] = tuple(counts)
        got = r.read()
    assert (got[:512, :512] == 7).all()
    assert (got[512:, 512:] == 0).all()


def test_bigtiff_read(tmp_path):
    """Hand-craft a minimal BigTIFF (uncompressed, one strip) and read
    it (Copernicus DEM distributions can be BigTIFF)."""
    import struct
    h, w = 20, 30
    arr = (np.arange(h * w) % 251).astype(np.uint8).reshape(h, w)
    data = arr.tobytes()

    entries = []

    def entry(tag, typ, count, value_bytes):
        entries.append(struct.pack('<HHQ', tag, typ, count)
                       + value_bytes.ljust(8, b'\0'))

    data_offset = 16 + 8 + 11 * 20 + 8
    entry(256, 4, 1, struct.pack('<I', w))          # width
    entry(257, 4, 1, struct.pack('<I', h))          # length
    entry(258, 3, 1, struct.pack('<H', 8))          # bits
    entry(259, 3, 1, struct.pack('<H', 1))          # no compression
    entry(262, 3, 1, struct.pack('<H', 1))          # minisblack
    entry(273, 16, 1, struct.pack('<Q', data_offset))  # strip offset
    entry(277, 3, 1, struct.pack('<H', 1))          # samples
    entry(278, 4, 1, struct.pack('<I', h))          # rows per strip
    entry(279, 16, 1, struct.pack('<Q', len(data)))  # strip bytes
    entry(284, 3, 1, struct.pack('<H', 1))          # chunky
    entry(339, 3, 1, struct.pack('<H', 1))          # uint

    path = str(tmp_path / 'big.tif')
    with open(path, 'wb') as fh:
        fh.write(struct.pack('<2sHHHQ', b'II', 43, 8, 0, 16))
        fh.write(struct.pack('<Q', len(entries)))
        fh.write(b''.join(entries))
        fh.write(struct.pack('<Q', 0))  # next IFD
        fh.write(data)
    with TiffReader(path) as r:
        assert r.bigtiff
        np.testing.assert_array_equal(r.read(), arr)


class TestPayloadCache:
    """write_cog(payload_key=...): reuse of decimated+compressed tile
    payloads across identical-pixel writes (the campaign's per-grid DEM
    layer — io/cog.py PAYLOAD_CACHE)."""

    def _write(self, path, arr, meta, key, **kw):
        write_cog(str(path), arr, geotransform=(600000, 30, 0, 4500000,
                                                0, -30),
                  epsg=32615, nodata=float('nan'),
                  metadata=meta, payload_key=key, **kw)

    def test_hit_reuses_blobs_and_rebuilds_tags(self, tmp_path,
                                                monkeypatch):
        from proteus_jax.io import cog
        cog.PAYLOAD_CACHE.clear()
        rng = np.random.default_rng(7)
        arr = rng.normal(size=(700, 650)).astype(np.float32)
        builds = []
        orig = cog._IfdPlan.build_tiles
        monkeypatch.setattr(
            cog._IfdPlan, 'build_tiles',
            lambda self, pool: builds.append(1) or orig(self, pool))
        a, b = tmp_path / 'a.tif', tmp_path / 'b.tif'
        self._write(a, arr, {'SENSING_TIME': 'T1'}, key=('dem', 1))
        n_levels = len(builds)
        assert n_levels >= 1
        self._write(b, arr, {'SENSING_TIME': 'T2'}, key=('dem', 1))
        assert len(builds) == n_levels  # no re-encode on the hit
        # both files are valid standalone COGs with their own metadata
        for path, stamp in ((a, 'T1'), (b, 'T2')):
            assert validate_cog(str(path), full_check=True) == []
            with TiffReader(str(path)) as r:
                np.testing.assert_array_equal(r.read(), arr)
                assert r.metadata()['SENSING_TIME'] == stamp
        cog.PAYLOAD_CACHE.clear()

    def test_key_separates_different_payloads(self, tmp_path):
        from proteus_jax.io import cog
        cog.PAYLOAD_CACHE.clear()
        rng = np.random.default_rng(8)
        a1 = rng.normal(size=(260, 260)).astype(np.float32)
        a2 = rng.normal(size=(260, 260)).astype(np.float32)
        p1, p2 = tmp_path / '1.tif', tmp_path / '2.tif'
        self._write(p1, a1, None, key=('dem', 'g1'))
        self._write(p2, a2, None, key=('dem', 'g2'))
        with TiffReader(str(p1)) as r:
            np.testing.assert_array_equal(r.read(), a1)
        with TiffReader(str(p2)) as r:
            np.testing.assert_array_equal(r.read(), a2)
        cog.PAYLOAD_CACHE.clear()

    def test_cap_zero_disables(self, tmp_path, monkeypatch):
        from proteus_jax.io import cog
        cog.PAYLOAD_CACHE.clear()
        monkeypatch.setenv('PROTEUS_COG_PAYLOAD_CACHE', '0')
        arr = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
        builds = []
        orig = cog._IfdPlan.build_tiles
        monkeypatch.setattr(
            cog._IfdPlan, 'build_tiles',
            lambda self, pool: builds.append(1) or orig(self, pool))
        self._write(tmp_path / 'x.tif', arr, None, key=('k',))
        n = len(builds)
        self._write(tmp_path / 'y.tif', arr, None, key=('k',))
        assert len(builds) == 2 * n  # cache disabled: re-encoded
        cog.PAYLOAD_CACHE.clear()

    def test_campaign_dem_write_passes_key(self, tmp_path):
        """_write_tile forwards dem_payload_key: two tiles on the same
        grid encode the DEM payload once (hit observed via the cache's
        internal store)."""
        from proteus_jax.io import cog
        from proteus_jax.parallel.campaign import _write_tile, TileJob
        cog.PAYLOAD_CACHE.clear()
        dem = np.linspace(0, 800, 96 * 96,
                          dtype=np.float32).reshape(96, 96)
        science = {name: np.zeros((96, 96), np.uint8)
                   for name in ('WTR', 'BWTR', 'CONF', 'WTR-1', 'WTR-2',
                                'CLOUD')}
        science['DIAG'] = np.zeros((96, 96), np.uint16)
        base = dict(geotransform=(600000, 30, 0, 4500000, 0, -30),
                    projection='EPSG:32615', length=96, width=96)
        for i in range(2):
            job = TileJob(f't{i}', [], str(tmp_path / f't{i}'))
            image_dict = dict(base, dem=dem,
                              dem_payload_key=('dem_warp', 'sig',
                                               base['geotransform'],
                                               base['projection'],
                                               96, 96, 0))
            _write_tile(job, dict(science), image_dict,
                        {'SENSING_TIME': f'T{i}'})
        assert len(cog.PAYLOAD_CACHE._entries) == 1
        for i in range(2):
            tifs = glob.glob(str(tmp_path / f't{i}' / '*_DEM.tif'))
            assert len(tifs) == 1
            assert validate_cog(tifs[0], full_check=True) == []
            with TiffReader(tifs[0]) as r:
                np.testing.assert_array_equal(r.read(), dem)
                assert r.metadata()['SENSING_TIME'] == f'T{i}'
        cog.PAYLOAD_CACHE.clear()
