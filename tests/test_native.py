"""Native tiffturbo codec parity tests (vs the pure-Python codecs)."""

import numpy as np
import pytest

from proteus_jax import native
from proteus_jax.io import codecs

pytestmark = pytest.mark.skipif(not native.available(),
                                reason='native codec not built')

RNG = np.random.default_rng(9)


def test_inflate_matches_zlib():
    raw = bytes(RNG.integers(0, 30, 100000).astype(np.uint8))
    comp = codecs.deflate_encode(raw)
    assert native.inflate(comp, len(raw)) == raw


def test_lzw_decode_matches_python():
    raw = bytes(RNG.integers(0, 200, 300000).astype(np.uint8))
    comp = codecs.lzw_encode(raw)
    assert native.lzw_decode(comp, len(raw)) == raw
    assert codecs.lzw_decode(comp) == raw


@pytest.mark.parametrize('samples', [1, 3, 10])
@pytest.mark.parametrize('dtype,predictor', [
    (np.uint8, codecs.PREDICTOR_HORIZONTAL),
    (np.int16, codecs.PREDICTOR_HORIZONTAL),
    (np.uint16, codecs.PREDICTOR_HORIZONTAL),
    (np.float32, codecs.PREDICTOR_FLOAT)])
def test_deflate_tiles_matches_python(dtype, predictor, samples):
    if np.dtype(dtype).kind == 'f':
        tiles = RNG.normal(size=(3, 64, 64, samples)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        tiles = RNG.integers(info.min, info.max,
                             (3, 64, 64, samples)).astype(dtype)
    blobs = native.deflate_tiles(tiles, predictor)
    for i, blob in enumerate(blobs):
        raw = codecs.deflate_decode(blob)
        if predictor == codecs.PREDICTOR_FLOAT:
            raw = codecs.unpredict_float(raw, 64, 64, samples,
                                         np.dtype(dtype).itemsize)
            got = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder(
                '>')).astype(dtype).reshape(64, 64, samples)
        else:
            got = np.frombuffer(raw, dtype=dtype).reshape(64, 64, samples)
            got = codecs.unpredict_horizontal(got, samples)
        np.testing.assert_array_equal(got, tiles[i])


@pytest.mark.parametrize('factor', [4, 16, 64])
@pytest.mark.parametrize('samples', [1, 3])
def test_bspline_decimate_matches_numpy(factor, samples):
    """Native CUBICSPLINE overview decimation must be bit-identical to
    the NumPy implementation (same float64 tap order/renormalization)."""
    from proteus_jax.io import cog
    shape = (333, 291, samples)
    arr = (1000 * RNG.normal(size=shape)).astype(np.float32)
    arr[RNG.random(shape) < 0.02] = np.nan
    out = cog._bspline_decimate_axis0(arr, factor)
    out = np.swapaxes(cog._bspline_decimate_axis0(
        np.swapaxes(out, 0, 1), factor), 0, 1)
    ref = np.ascontiguousarray(out).astype(np.float32)
    taps, weights = cog._bspline_taps(factor)
    got = native.bspline_decimate_f32(arr, factor, taps, weights)
    same = (ref == got) | (np.isnan(ref) & np.isnan(got))
    assert same.all()


def test_cog_native_vs_python_roundtrip(tmp_path):
    """COGs written with the native compressor must read back identically
    through the pure-Python decoder (and vice versa)."""
    import os
    from proteus_jax.io.cog import write_cog
    from proteus_jax.io.tiff import TiffReader
    arr = RNG.integers(0, 30000, (700, 650)).astype(np.int16)

    p_native = str(tmp_path / 'n.tif')
    write_cog(p_native, arr, epsg=32615)

    os.environ['PROTEUS_NO_NATIVE'] = '1'
    try:
        native._TRIED = False
        native._LIB = None
        assert not native.available()
        p_python = str(tmp_path / 'p.tif')
        write_cog(p_python, arr, epsg=32615)
        with TiffReader(p_native) as r:
            np.testing.assert_array_equal(r.read(), arr)
        with TiffReader(p_python) as r:
            np.testing.assert_array_equal(r.read(), arr)
    finally:
        del os.environ['PROTEUS_NO_NATIVE']
        native._TRIED = False
        native._LIB = None
    with TiffReader(p_python) as r:
        np.testing.assert_array_equal(r.read(), arr)
