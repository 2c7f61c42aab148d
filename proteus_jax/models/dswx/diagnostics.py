"""Diagnostic surface-water tests (DIAG layer) as a fused device kernel.

Implements the five DSWE diagnostic tests over the Blue/Green/Red/NIR/SWIR1/
SWIR2 reflectance channels (reference: dswx_hls.py:1840-1916):

    MNDWI = (green - swir1) / (green + swir1)
    MBSRV = green + red
    MBSRN = nir + swir1
    AWEsh = blue + 2.5*green - 1.5*MBSRN - 0.25*swir2
    NDVI  = (nir - red) / (nir + red)

    bit 0: MNDWI > wigt
    bit 1: MBSRV > MBSRN
    bit 2: AWEsh > awgt
    bit 3: MNDWI > pswt_1_mndwi and swir1 < pswt_1_swir1
           and nir < pswt_1_nir and ndvi < pswt_1_ndvi
    bit 4: MNDWI > pswt_2_mndwi and blue < pswt_2_blue
           and swir1 < pswt_2_swir1 and swir2 < pswt_2_swir2
           and nir < pswt_2_nir

For integer (unscaled) reflectance inputs — the production default — every
comparison is evaluated in exact int32 rational arithmetic, which is
*bit-identical* to the reference's NumPy float64 evaluation including its
int16 overflow-wrap behavior for MBSRV/MBSRN and the MNDWI/NDVI numerators
and denominators (NumPy keeps int16 + int16 in int16), and its inf/NaN
semantics for zero denominators. See proteus_jax.core.thresholds.
Thresholds that are not exact decimal fractions (e.g. a user-set 1/3)
take the boundary-exact float64-semantics path in core.f32exact instead
of the rational rewrite — still bit-identical, never approximate.

For float (pre-scaled) inputs the reference itself runs in float32 (its
ingest casts to float32 before scaling, dswx_hls.py:2298-2302), so all
adds/muls here match it bit-for-bit on device (IEEE f32). The MNDWI/NDVI
threshold comparisons avoid XLA's non-correctly-rounded division via
the division-free exact boundary tests in core.f32exact.
"""

import jax.numpy as jnp
import numpy as np

from proteus_jax.core.f32exact import (int_gt_bound, int_lt_bound,
                                       ratio_boundary, ratio_cmp)
from proteus_jax.core.thresholds import HlsThresholds, ExactThresholds

_I32 = jnp.int32


def _ratio_gt_exact(num, den, p, q):
    """num/den > p/q with float64-division semantics (num, den: int32)."""
    qnum = q * num
    pden = p * den
    return jnp.where(den > 0, qnum > pden,
                     jnp.where(den < 0, qnum < pden, num > 0))


def _ratio_lt_exact(num, den, p, q):
    """num/den < p/q with float64-division semantics."""
    qnum = q * num
    pden = p * den
    return jnp.where(den > 0, qnum < pden,
                     jnp.where(den < 0, qnum > pden, num < 0))


def _scalar_lt_exact(band_i32, p, q):
    """band < p/q for integer band values."""
    return band_i32 * q < p


def _ratio_cmp_approx(num, den, tval, op):
    """Plain float32 division compare — the fallback for pathological
    thresholds outside the exact-boundary domain (finite nonzero |t|
    below ~1e-30 needs subnormal f32 boundary parts, which core.f32exact
    rejects). Approximate by design: XLA's f32 division may be 1 ULP
    off, but at these magnitudes the reference's own comparison is
    equally degenerate, and crashing mid-product on a legal runconfig
    value is worse."""
    q = num.astype(jnp.float32) / den.astype(jnp.float32)
    t32 = jnp.float32(tval)
    return (q > t32) if op == 'gt' else (q < t32)


def _int_ratio_test(num, den, field, tval, op):
    """Exact int-path ratio test for any threshold value.

    Exact-decimal thresholds use the pure-int32 rational rewrite; the
    rest use the boundary-exact float64-semantics comparison (num/den are
    int16-derived, |.| < 2**24, hence exact float32 values).
    """
    if field[2]:
        fn = _ratio_gt_exact if op == 'gt' else _ratio_lt_exact
        return fn(num, den, *field[:2])
    try:
        b = ratio_boundary(tval, op, 'f64')
    except ValueError:
        return _ratio_cmp_approx(num, den, tval, op)
    return ratio_cmp(num.astype(jnp.float32), den.astype(jnp.float32), b)


def _float_ratio_test(num, den, tval, op):
    """Exact f32-semantics ratio test, with the division fallback for
    thresholds whose boundary has no normal-f32 decomposition."""
    try:
        b = ratio_boundary(tval, op, 'f32')
    except ValueError:
        return _ratio_cmp_approx(num, den, tval, op)
    return ratio_cmp(num, den, b)


def _int_scalar_lt(band_i32, field, tval):
    """band < tval (float64 semantics) for integer band values."""
    if field[2]:
        return _scalar_lt_exact(band_i32, *field[:2])
    bound = int_lt_bound(tval)
    if bound is None:
        return jnp.zeros(band_i32.shape, bool)
    bound = int(np.clip(bound, -2 ** 31 + 1, 2 ** 31 - 1))
    return band_i32 <= _I32(bound)


def _diag_tests_int(blue, green, red, nir, swir1, swir2,
                    et: ExactThresholds):
    """Integer-exact diagnostic tests. Inputs are int16 arrays."""
    # int16 wrap-around sums/differences, matching NumPy int16 arithmetic
    # (reference computes green-swir1 etc. on int16 arrays; dswx_hls.py:1872)
    mndwi_num = (green - swir1).astype(_I32)
    mndwi_den = (green + swir1).astype(_I32)
    mbsrv = (green + red)  # int16, wraps
    mbsrn = (nir + swir1)  # int16, wraps
    ndvi_num = (nir - red).astype(_I32)
    ndvi_den = (nir + red).astype(_I32)

    b32 = blue.astype(_I32)
    g32 = green.astype(_I32)
    s1_32 = swir1.astype(_I32)
    s2_32 = swir2.astype(_I32)
    n32 = nir.astype(_I32)

    # AWEsh * 4 is an exact integer: blue + 2.5g - 1.5*mbsrn - 0.25*s2
    # (mbsrn wraps in int16 first, as in the reference; the rest are exact
    # float64 ops on integers, all multiples of 0.25)
    awesh4 = 4 * b32 + 10 * g32 - 6 * mbsrn.astype(_I32) - s2_32

    tv = et.float_values
    t1 = _int_ratio_test(mndwi_num, mndwi_den, et.wigt, tv.wigt, 'gt')
    t2 = mbsrv > mbsrn  # pure int16 comparison, always exact
    if et.awgt[2]:
        p, q = et.awgt[:2]
        t3 = awesh4 * q > 4 * p
    else:
        # awesh = awesh4/4 exactly in float64; awesh > t <=> awesh4 > 4t
        bound = int_gt_bound(np.float64(tv.awgt) * 4)
        if bound is None:
            t3 = jnp.zeros(awesh4.shape, bool)
        else:
            bound = int(np.clip(bound, -2 ** 31 + 1, 2 ** 31 - 1))
            t3 = awesh4 >= _I32(bound)
    t4 = (_int_ratio_test(mndwi_num, mndwi_den, et.pswt_1_mndwi,
                          tv.pswt_1_mndwi, 'gt') &
          _int_scalar_lt(s1_32, et.pswt_1_swir1, tv.pswt_1_swir1) &
          _int_scalar_lt(n32, et.pswt_1_nir, tv.pswt_1_nir) &
          _int_ratio_test(ndvi_num, ndvi_den, et.pswt_1_ndvi,
                          tv.pswt_1_ndvi, 'lt'))
    t5 = (_int_ratio_test(mndwi_num, mndwi_den, et.pswt_2_mndwi,
                          tv.pswt_2_mndwi, 'gt') &
          _int_scalar_lt(b32, et.pswt_2_blue, tv.pswt_2_blue) &
          _int_scalar_lt(s1_32, et.pswt_2_swir1, tv.pswt_2_swir1) &
          _int_scalar_lt(s2_32, et.pswt_2_swir2, tv.pswt_2_swir2) &
          _int_scalar_lt(n32, et.pswt_2_nir, tv.pswt_2_nir))
    return t1, t2, t3, t4, t5


def _diag_tests_float(blue, green, red, nir, swir1, swir2,
                      t: HlsThresholds):
    """float32 diagnostic tests (pre-scaled reflectance inputs).

    The reference's scaled path is float32 end-to-end (its ingest casts
    to float32 at dswx_hls.py:2300 and NumPy keeps python-float scalars
    weak), so float32 adds/muls/compares here match it bit-for-bit. The
    two divisions (MNDWI, NDVI) never run on device — their threshold
    comparisons go through the division-free exact boundary tests, since
    XLA's float32 division is not correctly rounded.
    """
    f32 = jnp.float32
    mndwi_num, mndwi_den = green - swir1, green + swir1
    ndvi_num, ndvi_den = nir - red, nir + red
    mbsrv = green + red
    mbsrn = nir + swir1
    awesh = blue + f32(2.5) * green - f32(1.5) * mbsrn - f32(0.25) * swir2

    t1 = _float_ratio_test(mndwi_num, mndwi_den, t.wigt, 'gt')
    t2 = mbsrv > mbsrn
    t3 = awesh > f32(t.awgt)
    t4 = (_float_ratio_test(mndwi_num, mndwi_den, t.pswt_1_mndwi, 'gt') &
          (swir1 < f32(t.pswt_1_swir1)) &
          (nir < f32(t.pswt_1_nir)) &
          _float_ratio_test(ndvi_num, ndvi_den, t.pswt_1_ndvi, 'lt'))
    t5 = (_float_ratio_test(mndwi_num, mndwi_den, t.pswt_2_mndwi, 'gt') &
          (blue < f32(t.pswt_2_blue)) &
          (swir1 < f32(t.pswt_2_swir1)) &
          (swir2 < f32(t.pswt_2_swir2)) &
          (nir < f32(t.pswt_2_nir)))
    return t1, t2, t3, t4, t5


def compute_diagnostic_tests(blue, green, red, nir, swir1, swir2,
                             hls_thresholds: HlsThresholds):
    """Compute the 5-bit diagnostic layer (decimal representation, uint16).

    Matches reference _compute_diagnostic_tests (dswx_hls.py:1840-1916).
    Integer inputs use the exact int32 path; float inputs use float32.
    """
    if jnp.issubdtype(jnp.asarray(blue).dtype, jnp.integer):
        et = ExactThresholds.from_thresholds(hls_thresholds)
        tests = _diag_tests_int(blue, green, red, nir, swir1, swir2, et)
    else:
        tests = _diag_tests_float(blue, green, red, nir, swir1, swir2,
                                  hls_thresholds)
    t1, t2, t3, t4, t5 = tests
    diag = (t1.astype(jnp.uint16)
            + (t2.astype(jnp.uint16) << 1)
            + (t3.astype(jnp.uint16) << 2)
            + (t4.astype(jnp.uint16) << 3)
            + (t5.astype(jnp.uint16) << 4))
    return diag


def get_binary_representation(diagnostic_layer_decimal, nbits=6):
    """DIAG decimal (0..32) -> pseudo-binary decimal-digit representation.

    e.g. 0b10110 (22) -> 10110; the 6th bit (fill, 32) -> 65535.
    Matches reference _get_binary_representation (dswx_hls.py:4286-4317).
    """
    d = diagnostic_layer_decimal.astype(jnp.int32)
    out = jnp.zeros_like(d)
    for i in range(min(nbits, 5)):
        out = out + ((d >> i) & 1) * (10 ** i)
    if nbits > 5:
        out = jnp.where((d >> 5) & 1, 65535, out)
    return out.astype(jnp.uint16)


def binary_representation_lut():
    """33-entry uint16 LUT equivalent of get_binary_representation."""
    lut = np.zeros(33, dtype=np.uint16)
    for v in range(32):
        lut[v] = sum(((v >> i) & 1) * 10 ** i for i in range(5))
    lut[32] = 65535
    return lut
