"""Browse-image PNG generation.

Replaces the reference's gdal.Translate GeoTIFF->PNG path
(dswx_hls.py:2719-2783): reads the palette GeoTIFF browse layer, applies
the RGBA palette (alpha -> PNG tRNS transparency), resizes with nearest
neighbour, and writes an 8-bit palette PNG with ``zlib``.
"""

import logging
import struct
import zlib

import numpy as np

from proteus_jax.io.tiff import TiffReader

logger = logging.getLogger('dswx_hls')

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def nearest_indices(src_size, dst_size):
    """Source index of each output pixel for a nearest-neighbour resize:
    the pixel whose cell holds the output pixel's centre. The centres are
    accumulated in float64 one step at a time, as Pillow's NEAREST resize
    does, so that the picks agree with it where a centre lands within
    rounding of a cell edge."""
    step = src_size / dst_size
    centres = np.cumsum(np.r_[step * 0.5, np.full(dst_size - 1, step)])
    return np.minimum(centres.astype(np.int64), src_size - 1)


def resize_nearest(arr, height, width):
    return arr[nearest_indices(arr.shape[0], height)][
        :, nearest_indices(arr.shape[1], width)]


def _chunk(kind, data):
    body = kind + data
    return (struct.pack('>I', len(data)) + body
            + struct.pack('>I', zlib.crc32(body) & 0xFFFFFFFF))


def write_palette_png(path, indices, palette, alpha=None):
    """Write a (h, w) uint8 index image with a (256, 3) uint8 palette and
    optional (256,) uint8 alpha (tRNS) as an 8-bit palette PNG."""
    indices = np.ascontiguousarray(indices, dtype=np.uint8)
    h, w = indices.shape
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = 0  # filter type None on every scanline
    rows[:, 1:] = indices
    parts = [_PNG_SIGNATURE,
             _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 3, 0, 0, 0)),
             _chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())]
    if alpha is not None:
        parts.append(_chunk(b'tRNS', np.asarray(alpha, np.uint8).tobytes()))
    parts += [_chunk(b'IDAT', zlib.compress(rows.tobytes(), 6)),
              _chunk(b'IEND', b'')]
    with open(path, 'wb') as fh:
        fh.write(b''.join(parts))


def geotiff2png(src_geotiff_filename, dest_png_filename,
                output_height=None, output_width=None, logger_=None,
                rgba_ctable=None):
    """Convert a palette GeoTIFF into a resized PNG browse image."""
    with TiffReader(src_geotiff_filename) as r:
        arr = r.read()
        cmap = r.color_map()
    if arr.ndim != 2 or arr.dtype.kind not in 'ui':
        raise ValueError('geotiff2png expects a single-band integer '
                         f'(palette) raster, got {arr.dtype} {arr.shape}')
    h, w = arr.shape
    palette = np.zeros((256, 3), dtype=np.uint8)
    alpha = np.full(256, 255, dtype=np.uint8)
    if rgba_ctable:
        for v, rgba in rgba_ctable.items():
            palette[v] = rgba[:3]
            if len(rgba) == 4:
                alpha[v] = rgba[3]
    elif cmap:
        for v, rgb in cmap.items():
            palette[v] = rgb
    out = resize_nearest(arr.astype(np.uint8), output_height or h,
                         output_width or w)
    write_palette_png(dest_png_filename, out, palette, alpha)

    (logger_ or logger).info(
        f'Browse Image PNG created: {dest_png_filename}')
