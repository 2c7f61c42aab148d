"""HLS reflectance thresholds and their exact-rational device encoding.

The reference evaluates every diagnostic test in NumPy float64 over integer
reflectance values (reference: dswx_hls.py:1840-1916, HlsThresholds at
:274-318). On device we avoid float64 by rewriting each
threshold comparison in *exact integer arithmetic*:

    mndwi > t   with  mndwi = num/den,  t = p/q  (exact decimal fraction)

      den > 0:   q*num >  p*den
      den < 0:   q*num <  p*den
      den == 0:  num > 0          (num/0 -> +inf > t;  0/0 -> NaN -> False)

This is bit-exact w.r.t. the reference's float64 semantics: num, den are
int16-range integers, so |num/den - p/q| is either 0 or >= 1/(q*|den|) >=
1.5e-9 for q <= 1e4 — many orders of magnitude larger than the float64
rounding error of the division (< 1e-11), so the rounded comparison can never
disagree with the exact rational one. The equality case agrees too because
float64(p/q) == float64(t) when p/q is the exact decimal the user wrote.

If a threshold cannot be represented as p/q within the overflow-safe bounds,
the test falls back to float32 (flagged by ``exact=False``).
"""

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HlsThresholds:
    """HLS reflectance thresholds for generating DSWx-HLS products.

    Mirrors reference HlsThresholds (dswx_hls.py:274-318); default values are
    the science defaults from defaults/dswx_hls.yaml:176-212.
    """
    wigt: float = 0.124          # MNDWI threshold (test 1)
    awgt: float = 0.0            # AWEsh threshold (test 3)
    pswt_1_mndwi: float = -0.44  # PSW test-1 MNDWI threshold
    pswt_1_nir: float = 1500     # PSW test-1 NIR threshold
    pswt_1_swir1: float = 900    # PSW test-1 SWIR1 threshold
    pswt_1_ndvi: float = 0.7     # PSW test-1 NDVI threshold
    pswt_2_mndwi: float = -0.5   # PSW test-2 MNDWI threshold
    pswt_2_blue: float = 1000    # PSW test-2 Blue threshold
    pswt_2_nir: float = 2500     # PSW test-2 NIR threshold
    pswt_2_swir1: float = 3000   # PSW test-2 SWIR1 threshold
    pswt_2_swir2: float = 1000   # PSW test-2 SWIR2 threshold
    lcmask_nir: float = 1200     # landcover-mask NIR threshold

    @classmethod
    def from_dict(cls, d):
        """Build from a (possibly partial) dict; None values keep defaults."""
        kwargs = {k: v for k, v in (d or {}).items()
                  if v is not None and k in cls.__dataclass_fields__}
        return cls(**kwargs)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


def to_exact_fraction(value, max_den: int,
                      max_num: Optional[int] = None
                      ) -> Optional[Tuple[int, int]]:
    """Return (p, q) with p/q == float(value) *as a decimal* if possible.

    The fraction must satisfy q <= max_den, |p| <= max_num, and — critically —
    float(p/q) must round back to exactly the given float64 value, which
    guarantees the rational comparison is equivalent to the reference's
    float64 comparison (see module docstring). Returns None if no such
    fraction exists within the bounds.
    """
    try:
        f = float(value)
    except (TypeError, ValueError):
        return None
    if f != f or f in (float('inf'), float('-inf')):
        return None
    frac = Fraction(f).limit_denominator(max_den)
    p, q = frac.numerator, frac.denominator
    if max_num is not None and abs(p) > max_num:
        return None
    # round-trip check: p/q must be the real number whose float64
    # representation is exactly `f`
    if float(Fraction(p, q)) != f:
        return None
    return p, q


# Overflow-safe bounds for int32 device arithmetic:
#  - ratio tests (MNDWI/NDVI): |num|,|den| <= 65536 (int16-wrapped sums
#    promoted to int32) -> q*|num| and |p|*|den| must fit in int31.
RATIO_MAX_DEN = 10_000          # q*65536 <= 6.6e8 < 2^31
RATIO_MAX_NUM = 30_000          # p*65536 <= 2.0e9 < 2^31
#  - AWEsh test: |awesh4| = |4b + 10g - 6*mbsrn - s2| <= 7e5;
#    compare awesh4*q > 4*p  ->  q <= 3000, |4p| within int31.
AWESH_MAX_DEN = 3_000
AWESH_MAX_NUM = 400_000
#  - scalar band tests: |band| <= 32768, compare band*q < p.
SCALAR_MAX_DEN = 60_000
SCALAR_MAX_NUM = 2_000_000_000


@dataclasses.dataclass(frozen=True)
class ExactThresholds:
    """Compile-time rational encoding of HlsThresholds for the device kernel.

    Each field is (p, q, exact). When ``exact`` is False the kernel uses the
    float32 fallback for that test and stores (0, 1).
    """
    wigt: Tuple[int, int, bool]
    awgt: Tuple[int, int, bool]
    pswt_1_mndwi: Tuple[int, int, bool]
    pswt_1_nir: Tuple[int, int, bool]
    pswt_1_swir1: Tuple[int, int, bool]
    pswt_1_ndvi: Tuple[int, int, bool]
    pswt_2_mndwi: Tuple[int, int, bool]
    pswt_2_blue: Tuple[int, int, bool]
    pswt_2_nir: Tuple[int, int, bool]
    pswt_2_swir1: Tuple[int, int, bool]
    pswt_2_swir2: Tuple[int, int, bool]
    lcmask_nir: Tuple[int, int, bool]
    float_values: HlsThresholds = None  # kept for the float32 fallback path

    @classmethod
    def from_thresholds(cls, t: HlsThresholds) -> 'ExactThresholds':
        def enc(value, max_den, max_num):
            pq = to_exact_fraction(value, max_den, max_num)
            if pq is None:
                return (0, 1, False)
            return (pq[0], pq[1], True)

        return cls(
            wigt=enc(t.wigt, RATIO_MAX_DEN, RATIO_MAX_NUM),
            awgt=enc(t.awgt, AWESH_MAX_DEN, AWESH_MAX_NUM),
            pswt_1_mndwi=enc(t.pswt_1_mndwi, RATIO_MAX_DEN, RATIO_MAX_NUM),
            pswt_1_nir=enc(t.pswt_1_nir, SCALAR_MAX_DEN, SCALAR_MAX_NUM),
            pswt_1_swir1=enc(t.pswt_1_swir1, SCALAR_MAX_DEN, SCALAR_MAX_NUM),
            pswt_1_ndvi=enc(t.pswt_1_ndvi, RATIO_MAX_DEN, RATIO_MAX_NUM),
            pswt_2_mndwi=enc(t.pswt_2_mndwi, RATIO_MAX_DEN, RATIO_MAX_NUM),
            pswt_2_blue=enc(t.pswt_2_blue, SCALAR_MAX_DEN, SCALAR_MAX_NUM),
            pswt_2_nir=enc(t.pswt_2_nir, SCALAR_MAX_DEN, SCALAR_MAX_NUM),
            pswt_2_swir1=enc(t.pswt_2_swir1, SCALAR_MAX_DEN, SCALAR_MAX_NUM),
            pswt_2_swir2=enc(t.pswt_2_swir2, SCALAR_MAX_DEN, SCALAR_MAX_NUM),
            lcmask_nir=enc(t.lcmask_nir, SCALAR_MAX_DEN, SCALAR_MAX_NUM),
            float_values=t,
        )
