"""Terrain shadow layer (SHAD) from a pre-warped DEM, on device.

Two algorithms, selected by runconfig (reference default:
'sun_local_inc_angle'):

- ``compute_opera_shadow_layer``: sun local-incidence angle + directional
  slope thresholds from the DEM gradient (reference
  _compute_opera_shadow_layer, dswx_hls.py:4215-4283). Uses NumPy
  np.gradient semantics (central differences in the interior, one-sided at
  the edges).

- ``compute_opera_shadow_layer_exact``: the production variant —
  bit-identical to the reference's float64 decision chain. The reference,
  fed the float32 warped DEM, computes the gradient/terrain normal in
  float32 but the arccos/arctan threshold comparisons in float64 (NumPy 2
  promotion of float64 trig scalars). A plain float32 device chain flips a
  pixel whenever its angle lands within ~1 float32 ULP of the threshold
  (~1e-7/pixel — a few pixels per 3660^2 tile). Instead of emulating f64
  on the MXU, the device decides each pixel in *comparison space* (the
  cosine of the incidence angle vs a float64-bisected boundary; likewise
  tan of the directional slope), flags the epsilon-band of near-boundary
  pixels, and the host re-decides only those (typically zero) in float64
  with the reference's exact dtype mix. The decisions never route through
  a device transcendental, so the result is also invariant to device-vs-host
  libm differences.

- ``compute_hillshade_exact`` + ``compute_otsu_shadow_layer_exact``: GDAL
  DEMProcessing("hillshade") equivalent (Horn's formula, GDAL gdaldem
  conventions incl. the float->Byte round-half-up cast and the
  no-computeEdges border-nodata ring) followed by the reference's Otsu
  threshold (reference dswx_hls.py:4177-4212 and :1638-1684). The device
  computes the illumination in double-double f32 (error-free transforms;
  see core/f32exact.py) and brackets GDAL's float->Byte map at v +- E, so
  only true near-ties — typically a handful per tile at any elevation —
  need the host float64 oracle.

All variants consume a DEM with a margin (DEM_MARGIN_IN_PIXELS) that the
caller crops afterwards, so edge-handling differences never reach the
product.
"""

import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np

from proteus_jax.core.f32exact import _two_prod, _two_sum
from proteus_jax.ops.otsu import otsu_binarize


def _np_gradient_axis(h, axis):
    """np.gradient along one axis: central interior, one-sided edges."""
    h = h.astype(jnp.float32)
    if axis == 0:
        interior = (h[2:, :] - h[:-2, :]) * 0.5
        first = (h[1:2, :] - h[0:1, :])
        last = (h[-1:, :] - h[-2:-1, :])
        return jnp.concatenate([first, interior, last], axis=0)
    interior = (h[:, 2:] - h[:, :-2]) * 0.5
    first = (h[:, 1:2] - h[:, 0:1])
    last = (h[:, -1:] - h[:, -2:-1])
    return jnp.concatenate([first, interior, last], axis=1)


def compute_opera_shadow_layer(dem, sun_azimuth_angle, sun_elevation_angle,
                               min_slope_angle, max_sun_local_inc_angle,
                               pixel_spacing_x=30, pixel_spacing_y=30):
    """Shadow mask (True: not shadow / False: shadow) from sun geometry.

    Scalars are Python floats (compile-time constants per tile batch is also
    supported by passing jnp scalars).
    """
    sun_azimuth = jnp.float32(np.radians(sun_azimuth_angle)) \
        if np.isscalar(sun_azimuth_angle) else jnp.radians(sun_azimuth_angle)
    sun_zenith_degrees = 90.0 - sun_elevation_angle
    sun_zenith = jnp.float32(np.radians(sun_zenith_degrees)) \
        if np.isscalar(sun_zenith_degrees) else jnp.radians(sun_zenith_degrees)

    # target-to-sun unit vector (x, y, z)
    tsv_x = jnp.sin(sun_azimuth) * jnp.sin(sun_zenith)
    tsv_y = jnp.cos(sun_azimuth) * jnp.sin(sun_zenith)
    tsv_z = jnp.cos(sun_zenith)

    gy = _np_gradient_axis(dem, 0)
    gx = _np_gradient_axis(dem, 1)

    # terrain normal N = [-dh/dx, -dh/dy, 1] wrt the DEM grid; the reference
    # divides the row gradient by -abs(pixel_spacing_y) (north-up grid)
    tn_x = -gx / pixel_spacing_x
    tn_y = -gy / -abs(pixel_spacing_y)

    normalization = jnp.sqrt(tn_x ** 2 + tn_y ** 2 + 1.0)
    cos_inc = (tn_x * tsv_x + tn_y * tsv_y + tsv_z) / normalization
    sun_inc_angle_degrees = jnp.degrees(jnp.arccos(cos_inc))

    directional_slope_angle = jnp.degrees(jnp.arctan(
        tn_x * jnp.sin(sun_azimuth) + tn_y * jnp.cos(sun_azimuth)))

    backslope_mask = directional_slope_angle <= min_slope_angle
    low_sun_inc_angle_mask = sun_inc_angle_degrees <= max_sun_local_inc_angle
    shadow_mask = low_sun_inc_angle_mask | (~backslope_mask)
    return shadow_mask


# ---------------------------------------------------------------------------
# Exact (reference-float64-parity) shadow layer
# ---------------------------------------------------------------------------

# Max pixels host-resolved per tile before falling back to a full host
# recompute. Random 3660^2 terrain puts O(100) pixels in the epsilon band.
_MAX_UNCERTAIN = 16384
_EPS_X = 1e-5          # band half-width in cos(incidence) space
_EPS_T_REL = 1e-5      # band half-width in tan(slope) space, x(1+|t_crit|)


def _float_to_ordered_int(x):
    i = struct.unpack('<q', struct.pack('<d', float(x)))[0]
    return i if i >= 0 else -(i & 0x7FFFFFFFFFFFFFFF)


def _ordered_int_to_float(i):
    raw = i if i >= 0 else (-i) | (1 << 63)
    return struct.unpack('<d', struct.pack('<Q', raw & ((1 << 64) - 1)))[0]


def _bisect_largest_true(pred, lo, hi):
    """Largest float64 in [lo, hi] with pred true, for pred monotone
    nonincreasing (true below the boundary); None if pred(lo) is false.
    Bisection runs over the ordered-integer encoding of float64, so the
    boundary is exact to the last ULP."""
    ilo, ihi = _float_to_ordered_int(lo), _float_to_ordered_int(hi)
    if not pred(_ordered_int_to_float(ilo)):
        return None
    if pred(_ordered_int_to_float(ihi)):
        return _ordered_int_to_float(ihi)
    while ihi - ilo > 1:
        mid = (ilo + ihi) // 2
        if pred(_ordered_int_to_float(mid)):
            ilo = mid
        else:
            ihi = mid
    return _ordered_int_to_float(ilo)


def _bisect_smallest_true(pred, lo, hi):
    """Smallest float64 in [lo, hi] with pred true, for pred monotone
    nondecreasing; None if pred never true on the interval."""
    ilo, ihi = _float_to_ordered_int(lo), _float_to_ordered_int(hi)
    if not pred(_ordered_int_to_float(ihi)):
        return None
    if pred(_ordered_int_to_float(ilo)):
        return _ordered_int_to_float(ilo)
    while ihi - ilo > 1:
        mid = (ilo + ihi) // 2
        if pred(_ordered_int_to_float(mid)):
            ihi = mid
        else:
            ilo = mid
    return _ordered_int_to_float(ihi)


def _sun_vector_f64(sun_azimuth_angle, sun_elevation_angle):
    az = np.radians(np.float64(sun_azimuth_angle))
    zen = np.radians(np.float64(90.0 - np.float64(sun_elevation_angle)))
    return (np.sin(az) * np.sin(zen), np.cos(az) * np.sin(zen),
            np.cos(zen), np.sin(az), np.cos(az))


def _decision_boundaries(sun_azimuth_angle, sun_elevation_angle,
                         min_slope_angle, max_sun_local_inc_angle):
    """Exact float64 decision boundaries in comparison space.

    x_crit: smallest x in [-1, 1] with degrees(arccos(x)) <= max_inc
            (the low-incidence test is x >= x_crit within the domain).
    t_crit: largest t with degrees(arctan(t)) <= min_slope
            (the backslope test is t <= t_crit).
    """
    maxi = float(max_sun_local_inc_angle)
    mins = float(min_slope_angle)

    def p_inc(x):
        with np.errstate(invalid='ignore'):
            return bool(np.degrees(np.arccos(np.float64(x))) <= maxi)

    x_crit = _bisect_smallest_true(p_inc, -1.0, 1.0)
    if x_crit is None:
        x_crit = 2.0  # low-incidence test never true

    def p_slope(t):
        return bool(np.degrees(np.arctan(np.float64(t))) <= mins)

    t_crit = _bisect_largest_true(p_slope, -1.79e308, 1.79e308)
    if t_crit is None:
        t_crit = -1.79e308  # backslope never true -> ~backslope always
    return x_crit, t_crit


@functools.partial(jax.jit, static_argnames=('psx', 'psy'))
def _shadow_comparison_space(dem, tsv_f32, x_crit32, t_crit32,
                             eps_x, eps_t, psx=30, psy=30):
    """Device pass: f32 comparison-space decisions + uncertainty band.

    Returns (shadow, gx, gy, uncertain). The *gradients* — built from
    subtraction and an exact x0.5, so bit-identical to np.gradient — are
    what the host re-decision consumes: XLA strength-reduces division by a
    constant into a reciprocal multiply (~1 ULP off IEEE division), so the
    device tn values are only band-accurate, never handed to the host.
    """
    tsv_x, tsv_y, tsv_z, sin_az, cos_az = tsv_f32
    gy = _np_gradient_axis(dem, 0)
    gx = _np_gradient_axis(dem, 1)
    tn_x = -gx / psx
    tn_y = -gy / -abs(psy)

    norm = jnp.sqrt(tn_x ** 2 + tn_y ** 2 + 1.0)
    x = (tn_x * tsv_x + tn_y * tsv_y + tsv_z) / norm
    t = tn_x * sin_az + tn_y * cos_az

    low_inc = (x >= x_crit32) & (x <= 1.0)
    backslope = t <= t_crit32
    shadow = low_inc | (~backslope)

    # the f32 error of t scales with the terrain-normal magnitude (steep
    # or sentinel-valued DEMs give |tn| >> 1), so the t band widens per
    # pixel; x is normalized, so a constant band suffices
    eps_t_px = eps_t + jnp.float32(_EPS_T_REL) * (jnp.abs(tn_x)
                                                  + jnp.abs(tn_y))
    uncertain = (jnp.abs(x - x_crit32) <= eps_x) | \
                (jnp.abs(x) >= 1.0 - eps_x) | \
                (jnp.abs(t - t_crit32) <= eps_t_px)
    return shadow, gx, gy, uncertain


def _host_decide_f64(tn_x32, tn_y32, sun_azimuth_angle, sun_elevation_angle,
                     min_slope_angle, max_sun_local_inc_angle):
    """Reference-exact float64 decision from float32 terrain normals.

    Replicates the reference's dtype mix under NumPy 2 (dswx_hls.py:
    4245-4283): the normalization factor stays float32, the dot product and
    trig run in float64 (float32 array x float64 scalar promotes)."""
    tn_x = np.asarray(tn_x32, dtype=np.float32)
    tn_y = np.asarray(tn_y32, dtype=np.float32)
    tsv_x, tsv_y, tsv_z, sin_az, cos_az = _sun_vector_f64(
        sun_azimuth_angle, sun_elevation_angle)
    norm = np.sqrt(tn_x ** 2 + tn_y ** 2 + 1)  # float32, like the reference
    with np.errstate(invalid='ignore'):
        inc_deg = np.degrees(np.arccos(
            (tn_x * tsv_x + tn_y * tsv_y + tsv_z) / norm))
        dslope_deg = np.degrees(np.arctan(tn_x * sin_az + tn_y * cos_az))
    low_inc = inc_deg <= float(max_sun_local_inc_angle)
    backslope = dslope_deg <= float(min_slope_angle)
    return low_inc | (~backslope)


def _host_shadow_exact(dem, sun_azimuth_angle, sun_elevation_angle,
                       min_slope_angle, max_sun_local_inc_angle,
                       psx=30, psy=30):
    """Full host recompute with the reference's exact semantics (fallback
    path, and the primary path for float64 DEMs)."""
    g = np.gradient(dem)
    tn_x = -g[1] / psx
    tn_y = -g[0] / -abs(psy)
    if dem.dtype == np.float64:
        tsv_x, tsv_y, tsv_z, sin_az, cos_az = _sun_vector_f64(
            sun_azimuth_angle, sun_elevation_angle)
        norm = np.sqrt(tn_x ** 2 + tn_y ** 2 + 1)
        with np.errstate(invalid='ignore'):
            inc_deg = np.degrees(np.arccos(
                (tn_x * tsv_x + tn_y * tsv_y + tsv_z) / norm))
            dslope_deg = np.degrees(np.arctan(
                tn_x * sin_az + tn_y * cos_az))
        low_inc = inc_deg <= float(max_sun_local_inc_angle)
        backslope = dslope_deg <= float(min_slope_angle)
        return low_inc | (~backslope)
    return _host_decide_f64(tn_x, tn_y, sun_azimuth_angle,
                            sun_elevation_angle, min_slope_angle,
                            max_sun_local_inc_angle)


def compute_opera_shadow_layer_exact(dem, sun_azimuth_angle,
                                     sun_elevation_angle, min_slope_angle,
                                     max_sun_local_inc_angle,
                                     pixel_spacing_x=30, pixel_spacing_y=30,
                                     as_device=False):
    """Shadow mask bit-identical to the reference float64 chain.

    Accepts a host or device DEM. float32 DEMs (the production case —
    Copernicus GLO-30 after cubic warp) run on device with host resolution
    of the epsilon band; float64 DEMs run on host directly. Returns a host
    numpy bool array, or (``as_device=True``) a device bool array — the
    epsilon band is then patched by a device scatter of the host-decided
    values, so the full mask never leaves the device.
    """
    if isinstance(dem, np.ndarray) and dem.dtype == np.float64:
        out = _host_shadow_exact(dem, sun_azimuth_angle,
                                 sun_elevation_angle, min_slope_angle,
                                 max_sun_local_inc_angle,
                                 pixel_spacing_x, pixel_spacing_y)
        return jnp.asarray(out) if as_device else out

    x_crit, t_crit = _decision_boundaries(
        sun_azimuth_angle, sun_elevation_angle, min_slope_angle,
        max_sun_local_inc_angle)
    tsv64 = _sun_vector_f64(sun_azimuth_angle, sun_elevation_angle)
    tsv32 = tuple(jnp.float32(v) for v in tsv64)
    eps_t = np.float32(_EPS_T_REL * (1.0 + min(abs(t_crit), 1e30)))

    shadow, gx, gy, uncertain = _shadow_comparison_space(
        jnp.asarray(dem, dtype=jnp.float32), tsv32,
        jnp.float32(x_crit), jnp.float32(t_crit),
        jnp.float32(_EPS_X), eps_t,
        psx=pixel_spacing_x, psy=pixel_spacing_y)

    # one small fetch: band indices (+count via fill sentinel)
    idx = jnp.flatnonzero(uncertain, size=_MAX_UNCERTAIN, fill_value=-1)
    idx = np.asarray(idx)
    n_uncertain = int((idx >= 0).sum())

    if n_uncertain >= _MAX_UNCERTAIN:
        # epsilon band overflow (pathological flat-at-threshold DEM):
        # recompute everything on host with reference semantics
        out = _host_shadow_exact(np.asarray(dem, dtype=np.float32),
                                 sun_azimuth_angle, sun_elevation_angle,
                                 min_slope_angle, max_sun_local_inc_angle,
                                 pixel_spacing_x, pixel_spacing_y)
        return jnp.asarray(out) if as_device else out

    decided = None
    if n_uncertain:
        sel = idx[:n_uncertain]
        # recompute tn on host IEEE division (reference semantics) from the
        # bit-exact device gradients
        flat_gx = np.asarray(gx.ravel()[jnp.asarray(sel)],
                             dtype=np.float32)
        flat_gy = np.asarray(gy.ravel()[jnp.asarray(sel)],
                             dtype=np.float32)
        flat_tn_x = -flat_gx / pixel_spacing_x
        flat_tn_y = -flat_gy / -abs(pixel_spacing_y)
        decided = _host_decide_f64(flat_tn_x, flat_tn_y, sun_azimuth_angle,
                                   sun_elevation_angle, min_slope_angle,
                                   max_sun_local_inc_angle)

    if as_device:
        if decided is not None:
            flat = shadow.ravel().at[jnp.asarray(sel)].set(
                jnp.asarray(decided))
            shadow = flat.reshape(shadow.shape)
        return shadow

    shadow = np.array(shadow)  # writable host copy (np.asarray of a jax
    if decided is not None:    # array is a read-only view)
        flat = shadow.ravel()
        flat[sel] = decided
        shadow = flat.reshape(shadow.shape)
    return shadow


# ---------------------------------------------------------------------------
# GDAL-semantics hillshade (the reference's 'otsu' shadow branch)
# ---------------------------------------------------------------------------
#
# The reference routes the otsu branch through gdal.DEMProcessing
# ("hillshade", Horn, no -compute_edges; dswx_hls.py:4177-4212). The
# semantics replicated here, from GDAL's gdaldem implementation:
#   - 3x3 window values are read at the SOURCE precision (float32 for
#     the warped Copernicus DEM), the Horn/illumination algebra runs in
#     C double;
#   - output byte = trunc(float32(v) + 0.5f) with v = 1 + 254*cang
#     (1 where cang <= 0), clamped at 255 — GDAL's float->Byte
#     GDALCopyWord conversion (round-half-up, NOT round-half-even);
#   - without computeEdges the 1-pixel border ring is filled with the
#     hillshade dst nodata value 0 (this ring sits inside the 50 px DEM
#     margin and never reaches the product, but it DOES enter the Otsu
#     histogram: min() over the margined hillshade is pinned to 0).
# Byte-for-byte parity with a specific GDAL BINARY remains unverifiable
# offline (operation-ordering differs across GDAL versions); the
# guarantee here is device == this module's float64 host oracle, via
# the same epsilon-band + host-resolve machinery as the exact shadow
# path above.

_MAX_UNCERTAIN_HS = 131072


def _hillshade_consts_f64(sun_azimuth_angle, sun_elevation_angle):
    alt = np.radians(np.float64(sun_elevation_angle))
    az = np.radians(np.float64(sun_azimuth_angle))
    return (np.sin(alt), np.cos(az) * np.cos(alt),
            np.sin(az) * np.cos(alt))


def _hillshade_windows_np(z):
    """The 9 shifted 3x3-window views of a replicate-padded host array
    (only interior pixels are consumed; the border ring is overwritten
    with the GDAL edge nodata 0)."""
    p = np.pad(z, 1, mode='edge')
    return {(dy, dx): p[dy:dy + z.shape[0], dx:dx + z.shape[1]]
            for dy in (0, 1, 2) for dx in (0, 1, 2)}


def _hillshade_bytes_f64(w, sun_azimuth_angle, sun_elevation_angle,
                         pixel_spacing_x, pixel_spacing_y):
    """Float64 hillshade bytes from float32 3x3 window values.

    ``w`` maps (dy, dx) -> float32 arrays (any common shape). This is
    THE oracle the device path is bit-identical to."""
    sin_alt, cos_az_cos_alt, sin_az_cos_alt = _hillshade_consts_f64(
        sun_azimuth_angle, sun_elevation_angle)
    wd = {k: np.asarray(v, dtype=np.float64) for k, v in w.items()}
    x = ((wd[(0, 0)] + 2.0 * wd[(1, 0)] + wd[(2, 0)])
         - (wd[(0, 2)] + 2.0 * wd[(1, 2)] + wd[(2, 2)])) \
        / (8.0 * float(pixel_spacing_x))
    y = ((wd[(2, 0)] + 2.0 * wd[(2, 1)] + wd[(2, 2)])
         - (wd[(0, 0)] + 2.0 * wd[(0, 1)] + wd[(0, 2)])) \
        / (8.0 * float(pixel_spacing_y))
    num = sin_alt - (y * cos_az_cos_alt - x * sin_az_cos_alt)
    with np.errstate(invalid='ignore', over='ignore'):
        cang = num / np.sqrt(1.0 + x * x + y * y)
        v = np.where(num <= 0.0, 1.0, 1.0 + 254.0 * cang)
    f = v.astype(np.float32)
    with np.errstate(invalid='ignore'):
        out = np.where(f >= np.float32(255.0), np.float32(255.0),
                       np.trunc(f + np.float32(0.5)))
        # NaN windows: GDAL's float->Byte cast of NaN lands on 0 in
        # practice (x86/ARM float->int of NaN); pinned deterministically
        out = np.where(np.isnan(f), np.float32(0.0), out)
    return out.astype(np.uint8)


def _host_hillshade_gdal(dem32, sun_azimuth_angle, sun_elevation_angle,
                         pixel_spacing_x, pixel_spacing_y):
    """Full-array host oracle: float64 algebra + the border nodata
    ring."""
    z = np.asarray(dem32, dtype=np.float32)
    out = _hillshade_bytes_f64(_hillshade_windows_np(z),
                               sun_azimuth_angle, sun_elevation_angle,
                               pixel_spacing_x, pixel_spacing_y)
    out[0, :] = 0
    out[-1, :] = 0
    out[:, 0] = 0
    out[:, -1] = 0
    return out


# -- double-double f32 helpers (same technique as geo/warp.py's device
#    warp: f32 add/sub/mul are IEEE-exact, so Knuth/Dekker EFTs give
#    ~2^-44-relative arithmetic; f32 division/sqrt are sloppy (~1 ULP)
#    but one Newton refinement against an exact dd residual recovers
#    full dd accuracy).


def _dd_add(a, b):
    sh, se = _two_sum(a[0], b[0])
    return _two_sum(sh, se + (a[1] + b[1]))


def _dd_neg(a):
    return (-a[0], -a[1])


def _dd_mul(a, b):
    ph, pe = _two_prod(a[0], b[0])
    return _two_sum(ph, pe + (a[0] * b[1] + a[1] * b[0]))


def _dd_div(a, b):
    q0 = a[0] / b[0]
    r = _dd_add(a, _dd_neg(_dd_mul((q0, jnp.zeros_like(q0)), b)))
    return _two_sum(q0, (r[0] + r[1]) / b[0])


def _dd_sqrt(a):
    s0 = jnp.sqrt(a[0])
    t = _two_prod(s0, s0)
    r = _dd_add(a, (-t[0], -t[1]))
    c = (r[0] + r[1]) / (s0 + s0)
    return _two_sum(s0, jnp.where(a[0] > 0, c, jnp.zeros_like(c)))


def _dd_const(x):
    """Host split of a float64 constant into an f32 (hi, lo) pair."""
    hi = np.float32(x)
    return hi, np.float32(np.float64(x) - np.float64(hi))


def _hs_byte_map(f):
    """GDAL's float->Byte composite map in exact-IEEE f32 ops:
    trunc(fl32(f + 0.5f)) clamped at 255, NaN -> 0 (matches the
    oracle's GDALCopyWord semantics)."""
    b = jnp.where(f >= jnp.float32(255.0), jnp.float32(255.0),
                  jnp.trunc(f + jnp.float32(0.5)))
    return jnp.where(jnp.isnan(f), jnp.float32(0.0), b)


def _hillshade_consts_dd(sun_azimuth_angle, sun_elevation_angle):
    """Host split of the three f64 illumination constants into a (6,)
    f32 array of (hi, lo) pairs."""
    return jnp.asarray(np.array(
        [part for c in _hillshade_consts_f64(sun_azimuth_angle,
                                             sun_elevation_angle)
         for part in _dd_const(c)], dtype=np.float32))


@functools.partial(jax.jit, static_argnames=('psx', 'psy'))
def _hillshade_comparison_space(dem, consts_dd, psx, psy):
    """Device pass: hillshade bytes + the uncertainty band vs the f64
    oracle, computed in double-double f32.

    The oracle's f64 Horn sums/differences are EXACT (sums of f32
    values fit 53 bits), so the oracle deviates from exact real
    arithmetic only by its division/sqrt/downstream roundings
    (~1e-15 rel). The dd chain tracks exact arithmetic to ~1e-12 rel
    even under full cancellation, so evaluating GDAL's float->Byte
    composite map at v +- E (E covering both chains' error, with
    >1000x margin) brackets the oracle byte: pixels where the two
    endpoint bytes agree are proven; the rest go to host f64."""
    z = dem.astype(jnp.float32)
    zero = jnp.zeros_like(z)
    p = jnp.pad(z, 1, mode='edge')
    w = {(dy, dx): p[dy:dy + z.shape[0], dx:dx + z.shape[1]]
         for dy in (0, 1, 2) for dx in (0, 1, 2)}

    def dd(hi):
        return (hi, jnp.zeros_like(hi))

    def horn_sum(a, b, c):
        # a + 2b + c exactly (2b is exact in f32 barring overflow)
        s = _two_sum(a, c)
        return _dd_add(s, dd(b + b))

    # x = (left - right)/(8*psx): the oracle divides by the f64
    # constant; multiplying by its dd reciprocal (2^-48-rel pair) is
    # equivalent to within ~2^-44 rel — 5 orders inside the E margin.
    inv8psx = _dd_const(1.0 / (8.0 * float(psx)))
    inv8psy = _dd_const(1.0 / (8.0 * float(psy)))
    a_l = horn_sum(w[(0, 0)], w[(1, 0)], w[(2, 0)])
    a_r = horn_sum(w[(0, 2)], w[(1, 2)], w[(2, 2)])
    b_b = horn_sum(w[(2, 0)], w[(2, 1)], w[(2, 2)])
    b_t = horn_sum(w[(0, 0)], w[(0, 1)], w[(0, 2)])
    x = _dd_mul(_dd_add(a_l, _dd_neg(a_r)),
                (inv8psx[0] + zero, inv8psx[1] + zero))
    y = _dd_mul(_dd_add(b_b, _dd_neg(b_t)),
                (inv8psy[0] + zero, inv8psy[1] + zero))

    c_sin = (consts_dd[0] + zero, consts_dd[1] + zero)
    c_cos = (consts_dd[2] + zero, consts_dd[3] + zero)
    c_saz = (consts_dd[4] + zero, consts_dd[5] + zero)
    term = _dd_add(_dd_mul(y, c_cos), _dd_neg(_dd_mul(x, c_saz)))
    num = _dd_add(c_sin, _dd_neg(term))
    den = _dd_sqrt(_dd_add(_dd_add(dd(jnp.float32(1.0) + zero),
                                   _dd_mul(x, x)), _dd_mul(y, y)))
    cang = _dd_div(num, den)
    v254 = _dd_mul(cang, dd(jnp.float32(254.0) + zero))
    v = _dd_add(dd(jnp.float32(1.0) + zero), v254)
    # branch num <= 0 -> v = 1 (oracle tests the f64 num; num's dd sign
    # can disagree with the oracle's EXACT num only within ~2^-44 rel,
    # and v is continuous at num = 0 with value 1, so a sign flip
    # cannot move the byte: both branches give 1 there)
    is_dark = (num[0] < 0) | ((num[0] == 0) & (num[1] <= 0))
    vh = jnp.where(is_dark, jnp.float32(1.0), v[0])
    vl = jnp.where(is_dark, jnp.float32(0.0), v[1])

    maxw = zero
    win_finite = jnp.ones_like(z, bool)
    for wa in w.values():
        maxw = jnp.maximum(maxw, jnp.abs(wa))
        win_finite &= jnp.isfinite(wa)

    # E: dd-chain error (~1e-12 rel, sloppy-dd cancellation included)
    # + the oracle's own f64 rounding, both with >1000x margin; the
    # magnitude term also force-flags finite windows whose f32/dd
    # intermediates overflowed (E blows past a full byte there).
    inv_minps = 1.0 / min(abs(float(psx)), abs(float(psy)))
    E = (jnp.float32(1e-8) * (jnp.abs(vh) + 1.0)
         + jnp.float32(2.0 ** -26 * inv_minps) * maxw
         + jnp.float32(1e-10))

    f_mid = vh
    lo = _two_sum(vh, vl - E)[0]
    hi = _two_sum(vh, vl + E)[0]
    byte = _hs_byte_map(f_mid)
    b_lo = _hs_byte_map(lo)
    b_hi = _hs_byte_map(hi)
    uncertain = (b_lo != b_hi) & win_finite
    # finite windows whose dd value itself went nonfinite (sum
    # overflow): the oracle is finite there — always resolve on host
    uncertain |= win_finite & ~jnp.isfinite(vh)

    # GDAL edge ring (no computeEdges): dst nodata 0, never uncertain
    h_, w_ = z.shape
    row = jnp.arange(h_)[:, None]
    col = jnp.arange(w_)[None, :]
    ring = (row == 0) | (row == h_ - 1) | (col == 0) | (col == w_ - 1)
    byte = jnp.where(ring, jnp.float32(0.0), byte)
    uncertain = uncertain & ~ring
    return byte.astype(jnp.uint8), uncertain


def compute_hillshade_exact(dem, sun_azimuth_angle, sun_elevation_angle,
                            pixel_spacing_x=30.0, pixel_spacing_y=-30.0,
                            as_device=False):
    """Hillshade bytes bit-identical to the float64 GDAL-semantics
    oracle (`_host_hillshade_gdal`), computed on device in float32 with
    host float64 resolution of the epsilon band."""
    if isinstance(dem, np.ndarray):
        out = _host_hillshade_gdal(dem, sun_azimuth_angle,
                                   sun_elevation_angle,
                                   pixel_spacing_x, pixel_spacing_y)
        return jnp.asarray(out) if as_device else out

    consts_dd = _hillshade_consts_dd(sun_azimuth_angle,
                                     sun_elevation_angle)
    dem32 = jnp.asarray(dem, dtype=jnp.float32)
    byte, uncertain = _hillshade_comparison_space(
        dem32, consts_dd, psx=float(pixel_spacing_x),
        psy=float(pixel_spacing_y))

    # scalar count first (a 4-byte device->host copy), then an index
    # fetch sized to the common tiny band
    n_uncertain = int(jnp.sum(uncertain))
    if n_uncertain == 0:
        return byte if as_device else np.asarray(byte)
    if n_uncertain < _MAX_UNCERTAIN_HS:
        size = 1024 if n_uncertain <= 1024 else _MAX_UNCERTAIN_HS
        idx = np.asarray(jnp.flatnonzero(uncertain, size=size,
                                         fill_value=-1))

    if n_uncertain >= _MAX_UNCERTAIN_HS:
        out = _host_hillshade_gdal(np.asarray(dem32),
                                   sun_azimuth_angle,
                                   sun_elevation_angle,
                                   pixel_spacing_x, pixel_spacing_y)
        return jnp.asarray(out) if as_device else out

    if n_uncertain:
        sel = jnp.asarray(idx[:n_uncertain])
        # gather the flagged pixels' 3x3 float32 windows on device;
        # ONE small d2h fetch of the stacked values
        p = jnp.pad(dem32, 1, mode='edge')
        h_, w_ = dem32.shape
        vals = jnp.stack([
            p[dy:dy + h_, dx:dx + w_].ravel()[sel]
            for dy in (0, 1, 2) for dx in (0, 1, 2)])
        vals = np.asarray(vals, dtype=np.float32)
        wsel = {(dy, dx): vals[dy * 3 + dx]
                for dy in (0, 1, 2) for dx in (0, 1, 2)}
        decided = _hillshade_bytes_f64(wsel, sun_azimuth_angle,
                                       sun_elevation_angle,
                                       pixel_spacing_x, pixel_spacing_y)
        if as_device:
            flat = byte.ravel().at[sel].set(jnp.asarray(decided))
            return flat.reshape(byte.shape)
        out = np.array(byte)
        out.ravel()[np.asarray(sel)] = decided
        return out
    return byte if as_device else np.asarray(byte)


def _otsu_threshold_f64(value_counts):
    """The reference's Otsu threshold (dswx_hls.py:1638-1684) in
    float64 from a 256-entry BYTE-VALUE histogram (a sufficient
    statistic for a uint8 image): np.histogram's own binning over
    [min, max] via its weights path, then the cumulative inter-class
    variance argmax (NaN entries propagate through np.argmax exactly as
    in the reference)."""
    counts = np.asarray(value_counts, dtype=np.int64)
    present = np.flatnonzero(counts)
    if present.size == 0:
        return None
    values = present.astype(np.float64)
    hist, bin_edges = np.histogram(values, bins=256,
                                   weights=counts[present].astype(
                                       np.float64))
    hist = np.divide(hist.ravel(), hist.max())
    bin_mids = (bin_edges[:-1] + bin_edges[1:]) / 2.
    weight1 = np.cumsum(hist)
    weight2 = np.cumsum(hist[::-1])[::-1]
    with np.errstate(invalid='ignore', divide='ignore'):
        mean1 = np.cumsum(hist * bin_mids) / weight1
        mean2 = (np.cumsum((hist * bin_mids)[::-1])
                 / weight2[::-1])[::-1]
        inter_class_variance = (weight1[:-1] * weight2[1:]
                                * (mean1[:-1] - mean2[1:]) ** 2)
    index_of_max_val = np.argmax(inter_class_variance)
    return float(bin_mids[:-1][index_of_max_val])


def compute_otsu_shadow_layer_exact(dem, sun_azimuth_angle,
                                    sun_elevation_angle,
                                    pixel_spacing_x=30.0,
                                    pixel_spacing_y=-30.0,
                                    as_device=False):
    """Otsu shadow branch, bit-identical to the reference float64 chain
    given this module's hillshade oracle: exact hillshade bytes, the
    256-bin value histogram fetched as integers (1 KB), the threshold
    selected on host in float64 with the reference's exact formula, and
    the `hillshade > threshold` decision lowered to an integer byte
    comparison (True: not shadow)."""
    hs = compute_hillshade_exact(dem, sun_azimuth_angle,
                                 sun_elevation_angle, pixel_spacing_x,
                                 pixel_spacing_y, as_device=True)
    counts = np.asarray(jnp.zeros(256, jnp.int32).at[hs.ravel()].add(1))
    threshold = _otsu_threshold_f64(counts)
    # byte > float64 threshold  <=>  byte >= cut (exact: bytes are ints)
    over = np.arange(256, dtype=np.float64) > threshold
    cut = int(np.argmax(over)) if over.any() else 256
    if cut >= 256:
        mask = jnp.zeros(hs.shape, bool)
    else:
        mask = hs >= jnp.uint8(cut)
    return mask if as_device else np.asarray(mask)


def compute_hillshade(dem, sun_azimuth_angle, sun_elevation_angle,
                      pixel_spacing_x=30.0, pixel_spacing_y=-30.0):
    """GDAL gdaldem hillshade (Horn kernel), byte output: border ring 0
    (no computeEdges), interior 1..255 — single-pass device variant
    without the host band resolve (production uses
    `compute_hillshade_exact`)."""
    byte, _ = _hillshade_comparison_space(
        jnp.asarray(dem, dtype=jnp.float32),
        _hillshade_consts_dd(sun_azimuth_angle, sun_elevation_angle),
        psx=float(pixel_spacing_x), psy=float(pixel_spacing_y))
    return byte


def compute_otsu_shadow_layer(dem, sun_azimuth_angle, sun_elevation_angle,
                              pixel_spacing_x=30.0, pixel_spacing_y=-30.0):
    """Hillshade + Otsu binarization (True: not shadow) — single-pass
    float32 variant (production uses the exact variant above)."""
    hs = compute_hillshade(dem, sun_azimuth_angle, sun_elevation_angle,
                           pixel_spacing_x, pixel_spacing_y)
    return otsu_binarize(hs)
