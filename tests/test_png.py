"""The zlib browse-PNG writer against Pillow, which is the oracle here only.

Decoded indices, palette and alpha must be what Pillow reads back, and
the nearest-neighbour resize must pick the pixels Pillow's NEAREST
resize picks (the resampler the browse PNG used before).
"""

import numpy as np
import pytest

from proteus_jax.io.cog import write_cog
from proteus_jax.io.png import geotiff2png, resize_nearest, write_palette_png

Image = pytest.importorskip('PIL.Image')

RNG = np.random.default_rng(31)


def _palette_and_alpha():
    palette = RNG.integers(0, 256, (256, 3)).astype(np.uint8)
    alpha = np.full(256, 255, np.uint8)
    alpha[[0, 7, 255]] = [0, 128, 0]
    return palette, alpha


@pytest.mark.parametrize('shape', [(1, 1), (17, 33), (256, 256)])
def test_palette_png_decodes_like_pillow(tmp_path, shape):
    idx = RNG.integers(0, 256, shape).astype(np.uint8)
    palette, alpha = _palette_and_alpha()
    path = str(tmp_path / 'p.png')
    write_palette_png(path, idx, palette, alpha)
    with Image.open(path) as im:
        im.load()
        assert im.mode == 'P'
        assert im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), idx)
        got_palette = np.frombuffer(bytes(im.getpalette()), np.uint8)
        np.testing.assert_array_equal(got_palette.reshape(-1, 3)[:256],
                                      palette)
        np.testing.assert_array_equal(
            np.frombuffer(im.info['transparency'], np.uint8), alpha)


@pytest.mark.parametrize('src,dst', [((360, 360), (1024, 1024)),
                                     ((97, 53), (40, 70)),
                                     ((1024, 1024), (256, 300)),
                                     ((10, 10), (10, 10))])
def test_nearest_resize_matches_pillow(src, dst):
    arr = RNG.integers(0, 256, src).astype(np.uint8)
    want = np.asarray(Image.fromarray(arr, mode='L').resize(
        (dst[1], dst[0]), Image.NEAREST))
    np.testing.assert_array_equal(resize_nearest(arr, *dst), want)


def test_geotiff2png_browse(tmp_path):
    arr = RNG.integers(0, 6, (90, 120)).astype(np.uint8)
    src = str(tmp_path / 'browse.tif')
    write_cog(src, arr, geotransform=(600000.0, 30.0, 0.0, 3300000.0, 0.0,
                                      -30.0), epsg=32615,
              overview_levels=())
    ctable = {0: (255, 255, 255, 0), 1: (0, 0, 255, 255),
              2: (120, 120, 255, 255), 5: (10, 20, 30)}
    dst = str(tmp_path / 'browse.png')
    geotiff2png(src, dst, output_height=64, output_width=48,
                rgba_ctable=ctable)
    with Image.open(dst) as im:
        im.load()
        assert im.size == (48, 64)
        np.testing.assert_array_equal(np.asarray(im),
                                      resize_nearest(arr, 64, 48))
        rgba = np.asarray(im.convert('RGBA'))
    for value, color in ctable.items():
        hit = resize_nearest(arr, 64, 48) == value
        if hit.any():
            want = tuple(color) + ((255,) if len(color) == 3 else ())
            assert tuple(rgba[hit][0]) == want
