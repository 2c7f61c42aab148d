"""Warp-as-gather: reproject ancillary rasters onto the product grid.

Device replacement for the reference's gdal.Warp service (_warp,
dswx_hls.py:3193-3382): instead of shelling out to a warping library, every
target pixel center is inverse-projected to the source CRS with the exact
float64 UTM engine (proteus_jax.geo.crs), and the source raster is sampled
with the requested kernel (nearest / bilinear / cubic with GDAL's a=-0.5
convolution weights) honoring the source nodata. Antimeridian-crossing
tiles need no special split: longitudes are wrapped continuously, and
global geographic sources wrap their column index modulo the width
(the reference's two-sided crop+warp at dswx_hls.py:3315-3376 becomes a
no-op of the coordinate math).

Runs chunked on host in NumPy float64 today; the gather itself is simple
enough that XLA offload adds nothing until reads dominate (the codec is
the bottleneck, see proteus_jax/native).
"""

import logging
from datetime import datetime

import numpy as np

from proteus_jax.geo.crs import CRS, transform_points
from proteus_jax.io.tiff import TiffReader

logger = logging.getLogger('dswx_hls')

# supported resampling kernels and their tap radii (the reference only
# uses 'nearest' and 'cubic'; 'cubicspline' maps to cubic convolution;
# 'average' is footprint-based — its radius is data-dependent and
# resolved per call)
_KERNEL_RADIUS = {'nearest': 0, 'bilinear': 1, 'cubic': 2,
                  'cubicspline': 2, 'average': 2}


def _cubic_weights(t):
    """GDAL cubic-convolution weights (a = -0.5) for tap offsets
    -1, 0, 1, 2 given the fractional position t in [0, 1)."""
    a = -0.5
    def w(x):
        ax = np.abs(x)
        return np.where(
            ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
            np.where(ax < 2,
                     a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a,
                     0.0))
    return [w(t + 1), w(t), w(1 - t), w(2 - t)]


class SourceRaster:
    """A windowed view of the source raster with wrap/nodata handling."""

    def __init__(self, path):
        self.reader = TiffReader(path)
        self.gt = self.reader.geotransform()
        self.crs = self.reader.crs() or CRS.from_epsg(4326)
        self.width = self.reader.width
        self.length = self.reader.length
        self.nodata = self.reader.nodata()
        x0, dx, _, y0, _, dy = self.gt
        # global geographic sources wrap in longitude
        self.wraps = (self.crs.is_geographic
                      and abs(abs(self.width * dx) - 360.0) < 1e-6)

    def close(self):
        self.reader.close()

    def pixel_coords(self, x, y):
        """Continuous pixel-space coords (GDAL convention: 0..w, 0..h)."""
        x0, dx, _, y0, _, dy = self.gt
        u = (x - x0) / dx
        v = (y - y0) / dy
        if self.wraps:
            u = u % self.width
        return u, v


class GridTransformer:
    """Grid-interpolated coordinate transformer.

    Evaluates the exact float64 transform on a coarse lattice (every
    ``spacing`` target pixels) and bilinearly interpolates between lattice
    nodes — the same accelerization GDAL's approximate transformer uses.
    The Transverse Mercator mapping is analytic and smooth: with the
    default 8 px (240 m) spacing the interpolation error is bounded by
    (240 m)^2 / (2 R_earth) ~ 5 mm, four orders of magnitude below the
    10 m source grids. Longitudes are unwrapped across the antimeridian so
    interpolation stays continuous.
    """

    def __init__(self, tile_crs, src_crs, tx0, ty0, dx, dy, out_h, out_w,
                 spacing=8):
        self.spacing = spacing
        gi = np.arange(0, out_h + 2 * spacing, spacing, dtype=np.float64)
        gj = np.arange(0, out_w + 2 * spacing, spacing, dtype=np.float64)
        jj, ii = np.meshgrid(gj, gi)
        px = tx0 + (jj + 0.5) * dx
        py = ty0 + (ii + 0.5) * dy
        sx, sy = transform_points(tile_crs, src_crs, px.ravel(),
                                  py.ravel())
        sx = sx.reshape(jj.shape)
        sy = sy.reshape(jj.shape)
        if CRS.from_any(src_crs).is_geographic:
            # unwrap longitude jumps > 180 deg along both axes
            sx = np.unwrap(sx, period=360.0, axis=1)
            sx = np.unwrap(sx, period=360.0, axis=0)
        self.sx = sx
        self.sy = sy

    def __call__(self, i, j):
        """Transform target pixel indices (float arrays) to source CRS
        coordinates via bilinear lattice interpolation."""
        fi = i / self.spacing
        fj = j / self.spacing
        i0 = np.floor(fi).astype(np.int64)
        j0 = np.floor(fj).astype(np.int64)
        i0 = np.clip(i0, 0, self.sx.shape[0] - 2)
        j0 = np.clip(j0, 0, self.sx.shape[1] - 2)
        wi = fi - i0
        wj = fj - j0
        out = []
        for grid in (self.sx, self.sy):
            g00 = grid[i0, j0]
            g01 = grid[i0, j0 + 1]
            g10 = grid[i0 + 1, j0]
            g11 = grid[i0 + 1, j0 + 1]
            top = g00 + (g01 - g00) * wj
            bot = g10 + (g11 - g10) * wj
            out.append(top + (bot - top) * wi)
        return out[0], out[1]


def _resolve_window(src, u, v, radius):
    """Window of source pixels needed for the given pixel coords."""
    pad = radius + 2
    if src.wraps:
        return 0, 0, src.length, src.width  # modulo access: read it all
    c0 = int(np.floor(np.nanmin(u))) - pad
    c1 = int(np.ceil(np.nanmax(u))) + pad
    r0 = int(np.floor(np.nanmin(v))) - pad
    r1 = int(np.ceil(np.nanmax(v))) + pad
    c0 = max(c0, 0)
    r0 = max(r0, 0)
    c1 = min(c1, src.width)
    r1 = min(r1, src.length)
    return r0, c0, max(r1 - r0, 0), max(c1 - c0, 0)


def _gather(data, valid, rows, cols, wraps, width):
    h, w = data.shape
    if wraps:
        cols = cols % width
    inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    r = np.clip(rows, 0, h - 1)
    c = np.clip(cols, 0, w - 1)
    vals = data[r, c]
    ok = inb if valid is None else (inb & valid[r, c])
    return vals, ok


def _auto_grid_spacing(tile_crs, dx):
    """Lattice spacing in target pixels for ~240 m physical spacing
    (interpolation error ~(240 m)^2 / 2R ~ 5 mm); minimum 8 px.

    Power of two so lattice weights w = i/spacing - floor(i/spacing) are
    exact in BOTH float64 (host) and float32 (device) — a precondition
    for the bit-equal device nearest path (see _device_resample_impl).
    """
    if tile_crs.is_geographic:
        return 8
    target = max(8.0, 240.0 / max(abs(dx), 1e-9))
    return int(2 ** round(np.log2(target)))


def warp_to_grid(input_file, geotransform, projection, length, width,
                 resample_algorithm='nearest', margin_in_pixels=0,
                 chunk_rows=1024, dtype=None, transformer='grid',
                 grid_spacing=None):
    """Reproject ``input_file`` onto the target grid (plus margin).

    Returns an array of shape (length + 2*margin, width + 2*margin) in the
    source dtype (or ``dtype``). Pixels with no valid source data get the
    source nodata value (or 0 if the source has none), matching the
    gdal.Warp initialization the reference relies on.
    """
    m = margin_in_pixels
    x0, dx, _, y0, _, dy = geotransform
    tx0 = x0 - m * dx
    ty0 = y0 - m * dy
    out_h = length + 2 * m
    out_w = width + 2 * m
    tile_crs = CRS.from_any(projection)
    if grid_spacing is None:
        grid_spacing = _auto_grid_spacing(tile_crs, dx)

    src = SourceRaster(input_file)
    try:
        radius = _KERNEL_RADIUS.get(resample_algorithm)
        if radius is None:
            raise ValueError(
                f'unsupported resample algorithm: {resample_algorithm}')

        # coarse boundary sweep to find the needed source window
        bj = np.linspace(0, out_w, 256)
        bi = np.linspace(0, out_h, 256)
        edge_j = np.concatenate([bj, bj, np.zeros_like(bi),
                                 np.full_like(bi, out_w)])
        edge_i = np.concatenate([np.zeros_like(bj),
                                 np.full_like(bj, out_h), bi, bi])
        ex = tx0 + edge_j * dx
        ey = ty0 + edge_i * dy
        sx, sy = transform_points(tile_crs, src.crs, ex, ey)
        eu, ev = src.pixel_coords(sx, sy)
        r0, c0, wh, ww = _resolve_window(src, eu, ev, radius)
        if wh == 0 or ww == 0:
            fill = src.nodata if src.nodata is not None else 0
            out = np.full((out_h, out_w), fill)
            return out.astype(dtype or src.reader.dtype)

        data = src.reader.read(window=(r0, c0, wh, ww))
        if data.ndim == 3:
            data = data[:, :, 0]
        out_dtype = dtype or data.dtype
        nodata = src.nodata
        if nodata is not None and np.isnan(nodata):
            valid = ~np.isnan(data.astype(np.float64))
        elif nodata is not None:
            valid = data != nodata
        else:
            valid = np.ones(data.shape, dtype=bool)
        fill = nodata if nodata is not None else 0

        logger.info(f'    relocating file: {input_file}'
                    f' ({resample_algorithm}, window {wh}x{ww})')

        out = np.full((out_h, out_w), fill, dtype=np.float64)
        fdata = data.astype(np.float64)
        all_valid = bool(valid.all())

        grid_tx = None
        if transformer == 'grid':
            grid_tx = GridTransformer(tile_crs, src.crs, tx0, ty0, dx, dy,
                                      out_h, out_w, spacing=grid_spacing)

        for row0 in range(0, out_h, chunk_rows):
            rows = min(chunk_rows, out_h - row0)
            if resample_algorithm == 'average':
                # footprint-based: transform the PIXEL CORNERS
                # (index - 0.5 evaluates the center-sampled transform at
                # the corner positions)
                jj, ii = np.meshgrid(
                    np.arange(out_w + 1, dtype=np.float64) - 0.5,
                    np.arange(row0, row0 + rows + 1,
                              dtype=np.float64) - 0.5)
            else:
                jj, ii = np.meshgrid(np.arange(out_w, dtype=np.float64),
                                     np.arange(row0, row0 + rows,
                                               dtype=np.float64))
            if grid_tx is not None:
                sx, sy = grid_tx(ii, jj)
            else:
                px = tx0 + (jj + 0.5) * dx
                py = ty0 + (ii + 0.5) * dy
                sx, sy = transform_points(tile_crs, src.crs, px, py)
            u, v = src.pixel_coords(sx, sy)
            u = u - c0
            v = v - r0
            block_wraps = src.wraps and c0 == 0 and ww == src.width
            if resample_algorithm == 'average':
                block = _resample_block_average(
                    fdata, None if all_valid else valid, u, v, fill,
                    wraps=block_wraps, width=ww)
            else:
                block = _resample_block(fdata, valid, u, v,
                                        resample_algorithm, fill,
                                        wraps=block_wraps, width=ww,
                                        all_valid=all_valid)
            out[row0:row0 + rows, :] = block

        if np.dtype(out_dtype).kind in 'ui':
            out = np.rint(out)
            info = np.iinfo(out_dtype)
            out = np.clip(out, info.min, info.max)
        return out.astype(out_dtype)
    finally:
        src.close()


def _resample_block_average(fdata, valid, uc, vc, fill, wraps, width,
                            max_span=256):
    """GDAL 'average' semantics: area-weighted mean over the source-space
    bounding box of each target pixel's footprint.

    ``uc``/``vc`` are the CORNER coordinates of the target pixels in
    window-relative source pixel space, shape (rows+1, cols+1) — corner
    (i, j) is the top-left of pixel (i, j). Each source cell
    intersecting the footprint bbox contributes with weight equal to its
    overlap fraction per axis (gdal.Warp GRA_Average,
    gdalwarpkernel.cpp GWKAverageOrMode); nodata cells are skipped and
    the sum renormalized; zero total weight -> fill.
    """
    h, w = fdata.shape
    x00, x01 = uc[:-1, :-1], uc[:-1, 1:]
    x10, x11 = uc[1:, :-1], uc[1:, 1:]
    y00, y01 = vc[:-1, :-1], vc[:-1, 1:]
    y10, y11 = vc[1:, :-1], vc[1:, 1:]
    if wraps:
        # make the quad continuous around its top-left corner so
        # seam-crossing footprints get a sane bbox (gathers wrap below)
        def unwrap(x):
            return x - width * np.round((x - x00) / width)
        x01, x10, x11 = unwrap(x01), unwrap(x10), unwrap(x11)
    xmin = np.minimum(np.minimum(x00, x01), np.minimum(x10, x11))
    xmax = np.maximum(np.maximum(x00, x01), np.maximum(x10, x11))
    ymin = np.minimum(np.minimum(y00, y01), np.minimum(y10, y11))
    ymax = np.maximum(np.maximum(y00, y01), np.maximum(y10, y11))

    bad = ~(np.isfinite(xmin) & np.isfinite(xmax)
            & np.isfinite(ymin) & np.isfinite(ymax))
    xmin = np.where(bad, 0.0, xmin)
    xmax = np.where(bad, 0.0, xmax)
    ymin = np.where(bad, 0.0, ymin)
    ymax = np.where(bad, 0.0, ymax)

    ix0 = np.floor(xmin).astype(np.int64)
    iy0 = np.floor(ymin).astype(np.int64)
    nx = int(np.max(np.ceil(xmax) - ix0)) if xmin.size else 0
    ny = int(np.max(np.ceil(ymax) - iy0)) if ymin.size else 0
    if nx > max_span or ny > max_span:
        raise ValueError(
            f'average footprint spans {nx}x{ny} source cells; '
            f'downscale factor too extreme (cap {max_span})')

    acc = np.zeros(xmin.shape, np.float64)
    wacc = np.zeros(xmin.shape, np.float64)
    for dy in range(max(ny, 1)):
        cy = iy0 + dy
        wy = np.clip(np.minimum(cy + 1.0, ymax)
                     - np.maximum(cy, ymin), 0.0, None)
        rows_in = (cy >= 0) & (cy < h)
        cyc = np.clip(cy, 0, h - 1)
        for dx in range(max(nx, 1)):
            cx = ix0 + dx
            wx = np.clip(np.minimum(cx + 1.0, xmax)
                         - np.maximum(cx, xmin), 0.0, None)
            if wraps:
                cxc = cx % width
                cols_in = np.ones(cx.shape, bool)
            else:
                cols_in = (cx >= 0) & (cx < w)
                cxc = np.clip(cx, 0, w - 1)
            wgt = wx * wy
            vals = fdata[cyc, cxc]
            ok = rows_in & cols_in & (wgt > 0)
            if valid is not None:
                ok = ok & valid[cyc, cxc]
            acc += np.where(ok, vals * wgt, 0.0)
            wacc += np.where(ok, wgt, 0.0)
    with np.errstate(invalid='ignore', divide='ignore'):
        res = acc / wacc
    return np.where((wacc > 0) & ~bad, res, fill)


def _resample_block(fdata, valid, u, v, algorithm, fill, wraps, width,
                    all_valid=False):
    h, w = fdata.shape
    if algorithm == 'nearest':
        rows = np.floor(v).astype(np.int64)
        cols = np.floor(u).astype(np.int64)
        vals, ok = _gather(fdata, None if all_valid else valid,
                           rows, cols, wraps, width)
        return np.where(ok, vals, fill)

    # kernel-based: fractional position relative to pixel centers
    uc = u - 0.5
    vc = v - 0.5
    iu = np.floor(uc).astype(np.int64)
    iv = np.floor(vc).astype(np.int64)
    fu = uc - iu
    fv = vc - iv

    if algorithm == 'bilinear':
        taps = [(0, 1 - fv), (1, fv)]
        cols_w = [(0, 1 - fu), (1, fu)]
    else:  # cubic / cubicspline
        wv = _cubic_weights(fv)
        wu = _cubic_weights(fu)
        taps = list(zip((-1, 0, 1, 2), wv))
        cols_w = list(zip((-1, 0, 1, 2), wu))

    # pad the source so kernel taps never need bounds masks: data is
    # edge-replicated (wrap sources wrap in x); validity is False in the
    # pad so nodata renormalization handles true out-of-bounds taps.
    PAD = 2
    x_mode = 'wrap' if wraps else 'edge'
    dpad = np.pad(np.pad(fdata, ((PAD, PAD), (0, 0)), mode='edge'),
                  ((0, 0), (PAD, PAD)), mode=x_mode)
    center_in = (u >= 0) & (u <= w) & (v >= 0) & (v <= h)
    if wraps:
        iu = iu % width
        center_in = (v >= 0) & (v <= h)
    rbase = np.clip(iv, -PAD, h + PAD - 1) + PAD
    cbase = np.clip(iu, -PAD, w + PAD - 1) + PAD

    def _tap_rows(dr):
        # coordinates far outside the padded window (possible when the
        # tile extends past the source) clamp to the pad; such pixels
        # are outside center_in and masked to fill regardless
        return np.clip(rbase + dr, 0, h + 2 * PAD - 1)

    def _tap_cols(dc):
        return np.clip(cbase + dc, 0, w + 2 * PAD - 1)

    if all_valid and not wraps:
        # fast path: weights sum to 1 exactly; edge replication stands in
        # for GDAL's kernel clamping at the source border
        acc = np.zeros(u.shape, dtype=np.float64)
        for dr, wr in taps:
            rr = _tap_rows(dr)
            for dc, wc in cols_w:
                acc += (wr * wc) * dpad[rr, _tap_cols(dc)]
        return np.where(center_in, acc, fill)

    # validity pads follow the data pads in x: wrapping sources wrap
    # their validity modulo the width (a seam-crossing tap whose wrapped
    # column holds valid data IS valid — matching the device gather);
    # rows and non-wrapping x pad with False so out-of-window taps are
    # dropped and renormalized
    if all_valid:
        vpad = None
    else:
        vpad = np.pad(valid, ((PAD, PAD), (0, 0)), mode='constant',
                      constant_values=False)
        if wraps:
            vpad = np.pad(vpad, ((0, 0), (PAD, PAD)), mode='wrap')
        else:
            vpad = np.pad(vpad, ((0, 0), (PAD, PAD)), mode='constant',
                          constant_values=False)
    acc = np.zeros(u.shape, dtype=np.float64)
    wacc = np.zeros(u.shape, dtype=np.float64)
    for dr, wr in taps:
        rr = _tap_rows(dr)
        for dc, wc in cols_w:
            cc = _tap_cols(dc)
            wgt = wr * wc
            vals = dpad[rr, cc]
            if vpad is not None:
                ok = vpad[rr, cc]
                acc += np.where(ok, vals * wgt, 0.0)
                wacc += np.where(ok, wgt, 0.0)
            else:
                acc += vals * wgt
                wacc += wgt
    with np.errstate(invalid='ignore', divide='ignore'):
        res = acc / wacc
    return np.where(center_in & (wacc > 1e-9), res, fill)


from functools import lru_cache


def _dd_split(x):
    """Split a float64 array into a double-float32 (hi, lo) pair.

    hi + lo carries the top ~48 bits of x; the residual is <= |x|*2^-48.
    """
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


@lru_cache(maxsize=64)
def _device_resample_fn(h, w, gh, gw, spacing, out_h, out_w, algorithm,
                        fill, wraps, full_width, has_valid):
    """Build (and cache) the jitted device resampler for a static
    geometry/algorithm configuration, so repeated tiles reuse the
    compiled program."""
    import jax

    def wrapper(data, valid, lat):
        return _device_resample_impl(data, valid, lat, spacing,
                                     out_h, out_w, algorithm, fill,
                                     wraps, full_width)

    if has_valid:
        return jax.jit(wrapper)
    return jax.jit(lambda d, lat: wrapper(d, None, lat))


_NAN_FILL = float('nan')  # singleton: lru_cache keys hit via identity


def _device_resample(data, valid, lat, spacing, out_h, out_w,
                     algorithm, fill, wraps=False, full_width=None):
    """On-device warp: separable lattice interpolation of the source
    pixel coordinates + resampling gather, as one jit program.

    ``lat`` is (u_hi, u_lo, v_hi, v_lo): the window-relative source
    pixel coordinates of the exact-float64 lattice, split into
    double-float32 pairs. The interpolation runs in double-float32
    error-free transforms (IEEE f32 add/mul), so
    the interpolated coordinates agree with the host's float64 values to
    ~2^-45 relative — nearest-neighbor picks can only differ inside a
    ~1e-7 px boundary band, which the nearest path flags for exact host
    resolution (see warp_to_grid_device). Returns (out, ambiguous).
    """
    if isinstance(fill, float) and fill != fill:
        fill = _NAN_FILL  # distinct NaN objects would never cache-hit
    fn = _device_resample_fn(data.shape[0], data.shape[1],
                             lat[0].shape[0], lat[0].shape[1], spacing,
                             out_h, out_w, algorithm, fill, wraps,
                             full_width, valid is not None)
    if valid is not None:
        return fn(data, valid, lat)
    return fn(data, lat)


def _device_resample_impl(data, valid, lat, spacing, out_h,
                          out_w, algorithm, fill, wraps, full_width):
    import jax
    import jax.numpy as jnp
    from proteus_jax.core.f32exact import _two_prod, _two_sum

    h, w = data.shape
    gh, gw = lat[0].shape
    if spacing & (spacing - 1):
        raise ValueError(f'grid_spacing must be a power of two for the '
                         f'device warp (got {spacing})')

    def dd_norm(hi, lo):
        from proteus_jax.core.f32exact import _opaque
        s = _opaque(hi + lo)  # shield the fast-two-sum from reassociation
        return s, lo - (s - hi)

    def dd_add(ah, al, bh, bl):
        s, e = _two_sum(ah, bh)
        return dd_norm(s, e + (al + bl))

    def dd_mul_f32(ah, al, f):
        p, e = _two_prod(ah, f)
        return dd_norm(p, e + al * f)

    def dd_lerp(g0, g1, f):
        """g0 + (g1 - g0) * f in double-float32; g0/g1 are (hi, lo)."""
        dh, dl = dd_add(g1[0], g1[1], -g0[0], -g0[1])
        mh, ml = dd_mul_f32(dh, dl, f)
        return dd_add(g0[0], g0[1], mh, ml)

    def interp_axis0(grid_hi, grid_lo, i0, wi):
        a = (grid_hi[i0, :], grid_lo[i0, :])
        b = (grid_hi[i0 + 1, :], grid_lo[i0 + 1, :])
        return dd_lerp(a, b, wi[:, None])

    def interp_axis1(rows, j0, wj):
        a = (rows[0][:, j0], rows[1][:, j0])
        b = (rows[0][:, j0 + 1], rows[1][:, j0 + 1])
        return dd_lerp(a, b, wj[None, :])

    def run(data, valid, lat):
        u_hi, u_lo, v_hi, v_lo = lat
        # spacing is a power of two, so i/spacing and the lattice weights
        # are exact in f32 AND identical to the host's float64 values
        inv = jnp.float32(1.0 / spacing)
        fi = jnp.arange(out_h, dtype=jnp.float32) * inv
        fj = jnp.arange(out_w, dtype=jnp.float32) * inv
        i0 = jnp.clip(jnp.floor(fi).astype(jnp.int32), 0, gh - 2)
        j0 = jnp.clip(jnp.floor(fj).astype(jnp.int32), 0, gw - 2)
        wi = fi - i0.astype(jnp.float32)
        wj = fj - j0.astype(jnp.float32)

        udd = interp_axis1(interp_axis0(u_hi, u_lo, i0, wi), j0, wj)
        vdd = interp_axis1(interp_axis0(v_hi, v_lo, i0, wi), j0, wj)
        u, u_err = udd
        v, v_err = vdd

        dflat = data.reshape(-1)
        vflat = valid.reshape(-1) if valid is not None else None

        def gather(rows, cols):
            if wraps:
                cols = cols % full_width
            inb = ((rows >= 0) & (rows < h) & (cols >= 0) & (cols < w))
            r = jnp.clip(rows, 0, h - 1)
            c = jnp.clip(cols, 0, w - 1)
            flat = r * w + c
            vals = jnp.take(dflat, flat, mode='clip')
            ok = inb if vflat is None else \
                (inb & jnp.take(vflat, flat, mode='clip'))
            return vals, ok

        # exact dd floor. frac = hi - base must be ERROR-FREE: for
        # |hi| < 1 (base = -1, the wrap-seam band u in (0,1)) the f32
        # subtraction hi+1 rounds at ulp(1), a 2^-25 coordinate error
        # that kernel weights amplify by the tap value spread — far
        # outside the modeled ambiguity band (round-3 seam-fuzz find).
        # TwoSum tracks the residual; err can push frac across 0 or 1
        def dd_floor(hi, err):
            base = jnp.floor(hi)
            frac, frac_err = _two_sum(hi, -base)
            c, cl = _two_sum(frac, frac_err + err)
            shift = jnp.where(c < 0, jnp.float32(1.0),
                              jnp.where(c >= 1, jnp.float32(-1.0),
                                        jnp.float32(0.0)))
            n = base - shift
            # the +-1 wrap of the fraction must stay error-free: a plain
            # c + 1 rounds at ulp(1) and silently discards ~2^-25 of the
            # fraction — fatal when the coordinate sits just below an
            # integer (c ~ -1e-5 -> cf ~ 0.99999x needs the residual)
            cf, cl = dd_add(c, cl, shift, jnp.float32(0.0))
            return n.astype(jnp.int32), cf, cl

        # ambiguity band: where the dd value sits within eps of a floor
        # boundary, the host float64 value could floor differently; eps
        # bounds the dd-vs-f64 divergence (lattice split residual
        # 2^-48|coord| + O(5) dd-op errors) plus the f32 rounding of the
        # fraction itself (<= 2^-24)
        def near_edge(hi, cf):
            eps = jnp.float32(2.0 ** -22) \
                + (jnp.abs(hi) + 16.0) * jnp.float32(2.0 ** -38)
            return (cf < eps) | (cf > 1 - eps)

        if algorithm == 'nearest':
            rows, fv_n, _ = dd_floor(v, v_err)
            cols, fu_n, _ = dd_floor(u, u_err)
            amb = near_edge(u, fu_n) | near_edge(v, fv_n)
            # a floor flip far outside the source window cannot change
            # the (fill) result, and such coordinates may lie outside
            # what the host resolver can index; wrapping sources take
            # any u (modulo) so only the rows are bounded
            in_range = (v >= -1) & (v <= h + 1)
            if not wraps:
                in_range = in_range & (u >= -1) & (u <= w + 1)
            amb = amb & in_range
            vals, ok = gather(rows, cols)
            out = jnp.where(ok, vals, jnp.asarray(fill, data.dtype))
            return out, amb

        # --- kernel resamplers in double-f32: the host accumulates in
        # float64, so weights/products/sums run as dd here and pixels
        # whose dd value sits near an f32 rounding boundary (or near a
        # tap-selection boundary) are re-evaluated on host in float64
        def dd_addc(x, c):
            return dd_add(x[0], x[1], jnp.float32(c),
                          jnp.float32(0.0))

        def dd_mul(x, y):
            p, e = _two_prod(x[0], y[0])
            return dd_norm(p, e + (x[0] * y[1] + x[1] * y[0]))

        def dd_mulc(x, c):
            return dd_mul_f32(x[0], x[1], jnp.float32(c))

        uc = dd_add(u, u_err, jnp.float32(-0.5), jnp.float32(0.0))
        vc = dd_add(v, v_err, jnp.float32(-0.5), jnp.float32(0.0))
        iu, fu_hi, fu_lo = dd_floor(uc[0], uc[1])
        iv, fv_hi, fv_lo = dd_floor(vc[0], vc[1])
        amb = near_edge(uc[0], fu_hi) | near_edge(vc[0], fv_hi)
        fu = (fu_hi, fu_lo)
        fv = (fv_hi, fv_lo)

        def one_minus(x):
            return dd_add(jnp.float32(1.0), jnp.float32(0.0),
                          -x[0], -x[1])

        if algorithm == 'bilinear':
            taps = [(0, one_minus(fv)), (1, fv)]
            cols_w = [(0, one_minus(fu)), (1, fu)]
        else:
            # GDAL cubic (a=-0.5): |x|<=1: 1.5x^3-2.5x^2+1;
            # 1<|x|<2: -0.5x^3+2.5x^2-4x+2 — evaluated per tap on the
            # known-sign arguments f+1, f, 1-f, 2-f (dd Horner)
            def poly_inner(x):
                t = dd_addc(dd_mulc(x, 1.5), -2.5)
                t = dd_mul(t, x)
                t = dd_mul(t, x)
                return dd_addc(t, 1.0)

            def poly_outer(x):
                t = dd_addc(dd_mulc(x, -0.5), 2.5)
                t = dd_mul(t, x)
                t = dd_addc(t, -4.0)
                t = dd_mul(t, x)
                return dd_addc(t, 2.0)

            def two_minus(x):
                return dd_add(jnp.float32(2.0), jnp.float32(0.0),
                              -x[0], -x[1])

            taps = [(-1, poly_outer(dd_addc(fv, 1.0))),
                    (0, poly_inner(fv)),
                    (1, poly_inner(one_minus(fv))),
                    (2, poly_outer(two_minus(fv)))]
            cols_w = [(-1, poly_outer(dd_addc(fu, 1.0))),
                      (0, poly_inner(fu)),
                      (1, poly_inner(one_minus(fu))),
                      (2, poly_outer(two_minus(fu)))]

        # three accumulation modes mirroring _resample_block exactly:
        # - fast (no nodata, no wrap): every tap at full weight (edge
        #   replication via the clipping gather), NO renormalization
        # - unmasked wrap (no nodata, wrapping source): every tap at
        #   full weight (host pads row-edges/x-wrap but its vpad is
        #   None), with the acc/wacc division
        # - masked: validity-weighted taps + division
        if wraps:
            center_in = (v >= 0) & (v <= h)
        else:
            center_in = (u >= 0) & (u <= w) & (v >= 0) & (v <= h)
        zero = jnp.zeros(u.shape, jnp.float32)
        fast = valid is None and not wraps
        unmasked = valid is None
        acc = (zero, zero)
        wacc = (zero, zero)
        macc = zero  # magnitude accumulator: bounds the dd-vs-f64 error
        vmin = jnp.full(u.shape, jnp.inf, jnp.float32)
        vmax = jnp.full(u.shape, -jnp.inf, jnp.float32)
        for dr, wr in taps:
            for dc, wc in cols_w:
                vals, ok = gather(iv + dr, iu + dc)
                w2 = dd_mul(wr, wc)
                term = dd_mul_f32(w2[0], w2[1],
                                  vals.astype(jnp.float32))
                vf = vals.astype(jnp.float32)
                if unmasked:
                    macc = macc + jnp.abs(term[0])
                    vmin = jnp.minimum(vmin, vf)
                    vmax = jnp.maximum(vmax, vf)
                    acc = dd_add(acc[0], acc[1], term[0], term[1])
                    if not fast:
                        wacc = dd_add(wacc[0], wacc[1], w2[0], w2[1])
                else:
                    # a NaN (nodata) tap would poison the error trackers
                    # and disable the ambiguity flag
                    macc = macc + jnp.where(ok, jnp.abs(term[0]), 0.0)
                    vmin = jnp.minimum(vmin, jnp.where(ok, vf, jnp.inf))
                    vmax = jnp.maximum(vmax, jnp.where(ok, vf,
                                                       -jnp.inf))
                    acc = dd_add(acc[0], acc[1],
                                 jnp.where(ok, term[0], 0.0),
                                 jnp.where(ok, term[1], 0.0))
                    wacc = dd_add(wacc[0], wacc[1],
                                  jnp.where(ok, w2[0], 0.0),
                                  jnp.where(ok, w2[1], 0.0))

        def near_f32_boundary(hi, lo):
            # the f64 value rounds to a different f32 than hi only when
            # |lo| sits within the dd-vs-f64 error of ulp(hi)/2. That
            # error has two drivers, both scaling with the accumulated
            # TERM magnitudes (macc) rather than the result (cancelling
            # taps leave a small result with a larger absolute error):
            # accumulation roundoff (~macc*2^-45) and the coordinate
            # error amplified through the weight derivatives
            # (~macc * (|uc|+|vc|)*2^-46 — the dd coordinates carry
            # ~(|coord|+16)*2^-46 of divergence from the host float64)
            absh = jnp.abs(hi) + jnp.float32(1e-30)
            # exact half-ulp (an |hi|*2^-25 approximation is up to 2x
            # small and misses values sitting exactly ON the boundary,
            # where |lo| == ulp/2)
            half_ulp = (jnp.nextafter(absh, jnp.float32(jnp.inf))
                        - absh) * jnp.float32(0.5)
            coord_mag = jnp.abs(uc[0]) + jnp.abs(vc[0]) + 32.0
            spread = jnp.nan_to_num(vmax - vmin, nan=0.0, posinf=0.0,
                                    neginf=0.0)
            # err_scale: renormalization (1/wacc) amplifies both error
            # drivers when a pixel's valid-tap weight sum is small
            delta = half_ulp * jnp.float32(2.0 ** -16) \
                + err_scale * (macc * jnp.float32(2.0 ** -40)
                               + spread * coord_mag
                               * jnp.float32(2.0 ** -42))
            return jnp.abs(jnp.abs(lo) - half_ulp) < delta

        if fast:
            res_hi, res_lo = acc
            good = center_in
            err_scale = jnp.float32(1.0)
        else:
            # dd division: one Newton correction on the f32 quotient
            denom = jnp.where(wacc[0] > 1e-9, wacc[0], 1.0)
            q0 = acc[0] / denom
            r = dd_add(acc[0], acc[1],
                       *(lambda t: (-t[0], -t[1]))(
                           dd_mul_f32(wacc[0], wacc[1], q0)))
            res_hi, res_lo = dd_norm(*_two_sum(q0, r[0] / denom))
            good = center_in & (wacc[0] > 1e-9)
            amb = amb | (jnp.abs(wacc[0] - 1e-9) < 1e-12)
            err_scale = jnp.float32(1.0) / jnp.maximum(
                jnp.abs(denom), jnp.float32(2.0 ** -8))
            # below the clamp the 1/wacc amplification outruns any band
            # — just resolve those (rare: nearly-all-invalid kernels)
            amb = amb | (good & (jnp.abs(wacc[0])
                                 < jnp.float32(2.0 ** -8)))
        amb = amb | near_f32_boundary(res_hi, res_lo)
        out = jnp.where(good, res_hi, jnp.float32(fill))
        return out, amb & center_in

    return run(data, valid, lat)


def warp_to_grid_device(input_file, geotransform, projection, length,
                        width, resample_algorithm='nearest',
                        margin_in_pixels=0, grid_spacing=None,
                        dtype=None):
    """warp_to_grid with the interpolation+gather on the JAX device.

    Returns a device array (jnp). Keeping the result on device lets the
    downstream consumers (LAND decimation, terrain shadow) run without a
    host round-trip. The result is BIT-IDENTICAL to the host
    warp_to_grid for every resampler: coordinates AND kernel
    accumulation run in double-float32 error-free transforms on device,
    and every pixel inside the boundary-ambiguity band (floor/pick,
    f32 value-rounding, and integer-rint boundaries) is re-evaluated on
    host with the same float64 pipeline.
    """
    import jax.numpy as jnp

    if resample_algorithm == 'average':
        # footprint-based kernel with data-dependent tap counts: no
        # device path (no production input uses 'average'); the host
        # implementation is exact float64, so routing through it keeps
        # the bit-identity contract trivially
        out = warp_to_grid(input_file, geotransform, projection, length,
                           width, resample_algorithm='average',
                           margin_in_pixels=margin_in_pixels,
                           grid_spacing=grid_spacing, dtype=dtype)
        return jnp.asarray(out)

    m = margin_in_pixels
    x0, dx, _, y0, _, dy = geotransform
    tx0 = x0 - m * dx
    ty0 = y0 - m * dy
    out_h = length + 2 * m
    out_w = width + 2 * m
    tile_crs = CRS.from_any(projection)
    if grid_spacing is None:
        grid_spacing = _auto_grid_spacing(tile_crs, dx)

    src = SourceRaster(input_file)
    try:
        radius = _KERNEL_RADIUS[resample_algorithm]
        bj = np.linspace(0, out_w, 256)
        bi = np.linspace(0, out_h, 256)
        ej = np.concatenate([bj, bj, np.zeros_like(bi),
                             np.full_like(bi, out_w)])
        ei = np.concatenate([np.zeros_like(bj), np.full_like(bj, out_h),
                             bi, bi])
        sx, sy = transform_points(tile_crs, src.crs, tx0 + ej * dx,
                                  ty0 + ei * dy)
        eu, ev = src.pixel_coords(sx, sy)
        r0, c0, wh, ww = _resolve_window(src, eu, ev, radius)
        nodata = src.nodata
        fill = nodata if nodata is not None else 0
        out_dtype = dtype or src.reader.dtype
        if wh == 0 or ww == 0:
            return jnp.full((out_h, out_w), fill, dtype=out_dtype)

        data = src.reader.read(window=(r0, c0, wh, ww))
        if data.ndim == 3:
            data = data[:, :, 0]

        # exact-f64 lattice of window-relative source pixel coords;
        # computed continuously (no modulo) so bilinear interpolation
        # stays smooth across the antimeridian — the device gather
        # applies the wrap per pixel instead
        tx = GridTransformer(tile_crs, src.crs, tx0, ty0, dx, dy, out_h,
                             out_w, spacing=grid_spacing)
        sx0, sdx, _, sy0, _, sdy = src.gt
        lu = (tx.sx - sx0) / sdx
        lv = (tx.sy - sy0) / sdy
        u_hi, u_lo = _dd_split(lu - c0)
        v_hi, v_lo = _dd_split(lv - r0)
        lat = tuple(jnp.asarray(a) for a in (u_hi, u_lo, v_hi, v_lo))
        wraps = src.wraps and c0 == 0 and ww == src.width

        if nodata is not None and np.isnan(nodata):
            valid = ~np.isnan(data.astype(np.float64))
        elif nodata is not None:
            valid = data != nodata
        else:
            valid = None

        is_float_fill = isinstance(fill, float) and np.isnan(fill)
        kernel_input = data if resample_algorithm == 'nearest' else \
            data.astype(np.float32)
        all_valid = valid is None or bool(valid.all())
        out, amb = _device_resample(
            jnp.asarray(kernel_input),
            None if all_valid else jnp.asarray(valid),
            lat, grid_spacing, out_h, out_w, resample_algorithm,
            float(fill) if (is_float_fill or
                            resample_algorithm != 'nearest') else fill,
            wraps=wraps, full_width=ww)
        to_int = np.dtype(out_dtype).kind in 'ui' \
            and jnp.issubdtype(out.dtype, jnp.floating)
        if to_int and radius > 0:
            # kernel value near a half-integer: the f32 intermediate can
            # rint differently than the host's float64 — flag for the
            # f64 re-evaluation below
            half_dist = jnp.abs(out - jnp.floor(out)
                                - jnp.float32(0.5))
            amb = amb | (jnp.isfinite(out) & (half_dist < 1e-4))
        if to_int:
            # the host path accumulates in float64 and rint+clips for
            # any integer output dtype — mirror it (covers nearest with
            # a narrowing `dtype` override); ambiguous pixels are then
            # overwritten with the f64-converted host values
            out = jnp.clip(jnp.rint(out), np.iinfo(out_dtype).min,
                           np.iinfo(out_dtype).max)
        n_amb = int(jnp.sum(amb))
        if n_amb:
            # exact host re-evaluation of the boundary-ambiguous pixels,
            # replicating warp_to_grid's float64 chunk pipeline
            flat = np.asarray(jnp.nonzero(amb.ravel(), size=n_amb)[0])
            ii = (flat // out_w).astype(np.float64)
            jj = (flat % out_w).astype(np.float64)
            hsx, hsy = tx(ii, jj)
            hu, hv = src.pixel_coords(hsx, hsy)
            hu = hu - c0
            hv = hv - r0
            # mirror warp_to_grid's flags verbatim (all_valid with a
            # wrapping source selects the vpad=None unmasked branch of
            # _resample_block); restrict the float64 copy to the rows
            # the flagged pixels' taps can touch — columns stay whole
            # for the modulo wrap
            rlo = max(int(np.floor(np.nanmin(hv))) - 4, 0)
            rhi = min(int(np.ceil(np.nanmax(hv))) + 5, data.shape[0])
            rlo = min(rlo, data.shape[0] - 1)
            rhi = max(rhi, rlo + 1)
            # `all_valid` (computed above) is exactly warp_to_grid's
            # flag; when it holds, _resample_block never reads validity
            valid_slice = None if valid is None else valid[rlo:rhi]
            res = _resample_block(
                data[rlo:rhi].astype(np.float64), valid_slice,
                hu, hv - rlo, resample_algorithm, fill, wraps=wraps,
                width=ww, all_valid=all_valid)
            if to_int:
                res = np.clip(np.rint(res), np.iinfo(out_dtype).min,
                              np.iinfo(out_dtype).max)
            out = out.ravel().at[flat].set(
                jnp.asarray(res.astype(out.dtype))).reshape(out.shape)
        return out.astype(out_dtype)
    finally:
        src.close()


def worldcover_year_of(worldcover_file, worldcover_file_description=None):
    """Extract the WorldCover dataset year (reference
    dswx_hls.py:1055-1095): from time_start/time_end metadata, else from a
    year in the description, else 2000."""
    with TiffReader(worldcover_file) as r:
        md = r.metadata()
    if 'time_start' in md and 'time_end' in md:
        fmt = '%Y-%m-%dT%H:%M:%SZ'
        t0 = datetime.strptime(md['time_start'], fmt)
        t1 = datetime.strptime(md['time_end'], fmt)
        year = (t0 + (t1 - t0) / 2.0).year
        logger.info(f'    ESA WorldCover map year: {year}'
                    ' (source: WorldCover file metadata)')
        return year
    if worldcover_file_description:
        logger.warning('WARNING Could not read the ESA WorldCover 10m'
                       ' metadata fields `time_start` and/or `time_end`')
        for year in range(2000, 2100):
            if str(year) in worldcover_file_description:
                logger.info(f'    ESA WorldCover map year: {year}'
                            ' (source: WorldCover file description)')
                return year
        logger.warning('WARNING Could not infer the ESA WorldCover 10m'
                       ' data year from the WorldCover file description.'
                       ' Considering year as 2000.')
        return 2000
    logger.warning('WARNING Could not read the ESA WorldCover 10m metadata'
                   ' fields `time_start` and/or `time_end`.'
                   ' Considering year as 2000.')
    return 2000
