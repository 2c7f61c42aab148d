"""Native batched block decode parity tests.

tt_decode_blocks must return byte-identical rasters to the pure-Python
reader path for every (layout, compression, predictor, window)
combination.
"""

import struct
import zlib

import numpy as np
import pytest

from proteus_jax import native
from proteus_jax.io import codecs
from proteus_jax.io.cog import write_cog
from proteus_jax.io.tiff import TiffReader

pytestmark = pytest.mark.skipif(
    not (native.available() and native.has_decode_blocks()),
    reason='native codec not built')

RNG = np.random.default_rng(123)


def write_strip_tiff(path, arr, rows_per_strip, compression=8,
                     predictor=1, sparse_strips=()):
    """Minimal classic-TIFF strip writer (LE, single band) for reader
    tests — the repo's production writer emits tiled COGs only, but HLS
    upstream granules can be strip-organized."""
    h, w = arr.shape
    dtype = arr.dtype
    n_strips = (h + rows_per_strip - 1) // rows_per_strip
    payloads = []
    for s in range(n_strips):
        rows = min(rows_per_strip, h - s * rows_per_strip)
        block = arr[s * rows_per_strip:s * rows_per_strip + rows,
                    :, None]
        if predictor == codecs.PREDICTOR_HORIZONTAL:
            raw = codecs.predict_horizontal(block).tobytes()
        elif predictor == codecs.PREDICTOR_FLOAT:
            be = np.ascontiguousarray(block).astype(
                dtype.newbyteorder('>')).tobytes()
            raw = codecs.predict_float(be, rows, w, 1, dtype.itemsize)
        else:
            raw = block.tobytes()
        if compression == codecs.COMPRESSION_DEFLATE_ADOBE:
            data = zlib.compress(raw)
        elif compression == codecs.COMPRESSION_LZW:
            data = codecs.lzw_encode(raw)
        else:
            data = raw
        payloads.append(b'' if s in sparse_strips else data)

    header = b'II' + struct.pack('<HI', 42, 0)  # IFD offset patched below
    body = bytearray(header)
    offsets, counts = [], []
    for p in payloads:
        offsets.append(0 if not p else len(body))
        counts.append(len(p))
        body += p
    # external value areas for the offset/count arrays (LONG each)
    if n_strips > 1:
        off_area = len(body)
        body += struct.pack(f'<{n_strips}I', *offsets)
        cnt_area = len(body)
        body += struct.pack(f'<{n_strips}I', *counts)
    ifd_offset = len(body)
    struct.pack_into('<I', body, 4, ifd_offset)

    kind = {'u': 1, 'i': 2, 'f': 3}[dtype.kind]
    entries = [
        (256, 4, 1, w), (257, 4, 1, h),
        (258, 3, 1, dtype.itemsize * 8),
        (259, 3, 1, compression), (262, 3, 1, 1),
        (273, 4, n_strips,
         offsets[0] if n_strips == 1 else off_area),
        (277, 3, 1, 1), (278, 4, 1, rows_per_strip),
        (279, 4, n_strips,
         counts[0] if n_strips == 1 else cnt_area),
        (317, 3, 1, predictor), (339, 3, 1, kind),
    ]
    body += struct.pack('<H', len(entries))
    for tag, typ, cnt, val in sorted(entries):
        body += struct.pack('<HHI', tag, typ, cnt)
        body += struct.pack('<I', val) if typ == 4 \
            else struct.pack('<HH', val, 0)
    body += struct.pack('<I', 0)
    with open(path, 'wb') as fh:
        fh.write(body)


def _read_both(path, monkeypatch, **kw):
    with TiffReader(path) as r:
        got_native = r.read(**kw)
    monkeypatch.setattr(TiffReader, '_native_decode_ok',
                        lambda self, ifd, dtype: False)
    with TiffReader(path) as r:
        got_python = r.read(**kw)
    monkeypatch.undo()
    return got_native, got_python


@pytest.mark.parametrize('dtype', [np.uint8, np.int16, np.uint16,
                                   np.float32])
def test_tiled_reader_native_matches_python(tmp_path, dtype, monkeypatch):
    h, w = 700, 530  # non-multiples of the 512 tile -> edge tiles
    if np.dtype(dtype).kind == 'f':
        arr = RNG.normal(size=(h, w)).astype(dtype)
        arr[::97, ::53] = np.nan
    else:
        info = np.iinfo(dtype)
        arr = RNG.integers(info.min, info.max, (h, w)).astype(dtype)
    path = str(tmp_path / 'tiled.tif')
    write_cog(path, arr, epsg=32615, overview_levels=())
    for window in (None, (100, 37, 413, 301), (650, 500, 200, 200)):
        got_n, got_p = _read_both(path, monkeypatch, window=window)
        np.testing.assert_array_equal(got_n, got_p)
        ref = arr if window is None else \
            arr[window[0]:window[0] + window[2],
                window[1]:window[1] + window[3]]
        np.testing.assert_array_equal(got_n, ref)


def test_tiled_multiband_native_matches_python(tmp_path, monkeypatch):
    arr = RNG.integers(0, 255, (600, 600, 3)).astype(np.uint8)
    path = str(tmp_path / 'rgb.tif')
    write_cog(path, arr, epsg=32615, overview_levels=())
    got_n, got_p = _read_both(path, monkeypatch)
    np.testing.assert_array_equal(got_n, got_p)
    got_n, got_p = _read_both(path, monkeypatch, band=1)
    np.testing.assert_array_equal(got_n, got_p)


@pytest.mark.parametrize('dtype,predictor', [
    (np.int16, codecs.PREDICTOR_HORIZONTAL),
    (np.uint8, codecs.PREDICTOR_HORIZONTAL),
    (np.float32, codecs.PREDICTOR_FLOAT),
    (np.int16, codecs.PREDICTOR_NONE)])
@pytest.mark.parametrize('compression', [8, 1, codecs.COMPRESSION_LZW])
def test_strip_reader_native_matches_python(tmp_path, dtype, predictor,
                                            compression, monkeypatch):
    h, w = 333, 257
    if np.dtype(dtype).kind == 'f':
        arr = RNG.normal(size=(h, w)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        arr = RNG.integers(info.min, info.max, (h, w)).astype(dtype)
    path = str(tmp_path / 'strips.tif')
    # 64-row strips -> short 13-row last strip
    write_strip_tiff(path, arr, 64, compression=compression,
                     predictor=predictor)
    for window in (None, (50, 20, 150, 180), (320, 0, 13, 257)):
        got_n, got_p = _read_both(path, monkeypatch, window=window)
        np.testing.assert_array_equal(got_n, got_p)
        ref = arr if window is None else \
            arr[window[0]:window[0] + window[2],
                window[1]:window[1] + window[3]]
        np.testing.assert_array_equal(got_n, ref)


def test_strip_sparse_block_native_matches_python(tmp_path, monkeypatch):
    """Offset/count-0 strips decode as zeros (GDAL SPARSE_OK)."""
    arr = RNG.integers(0, 30000, (200, 100)).astype(np.int16)
    path = str(tmp_path / 'sparse.tif')
    write_strip_tiff(path, arr, 64, sparse_strips=(1,),
                     predictor=codecs.PREDICTOR_HORIZONTAL)
    got_n, got_p = _read_both(path, monkeypatch)
    np.testing.assert_array_equal(got_n, got_p)
    expect = arr.copy()
    expect[64:128] = 0
    np.testing.assert_array_equal(got_n, expect)


def test_corrupt_block_raises(tmp_path):
    arr = RNG.integers(0, 255, (100, 100)).astype(np.uint8)
    path = str(tmp_path / 'corrupt.tif')
    write_strip_tiff(path, arr, 64)
    data = bytearray(open(path, 'rb').read())
    data[20:40] = b'\xff' * 20  # clobber the first strip's stream
    open(path, 'wb').write(bytes(data))
    with TiffReader(path) as r:
        with pytest.raises(ValueError):
            r.read()
