"""Division-free exact float threshold comparisons on device.

Why this exists
---------------
The reference's scaled-input mode runs its whole diagnostic chain in
NumPy *float32* (reference dswx_hls.py:2298-2302 casts the reflectance to
float32 before scaling; :1872-1884 then computes MNDWI/NDVI/... on those
arrays, and comparisons against the python-float thresholds stay float32
under both value-based casting and NEP 50 weak promotion). XLA keeps
float32 add/sub/mul IEEE round-to-nearest, but it does not promise a
correctly rounded float32 *division*: it strength-reduces division by a
constant into a reciprocal multiply, and a backend may lower division to
a reciprocal-refinement sequence that lands 1 ULP off the correctly
rounded quotient — so computing ``num/den > t`` on device can flip
decisions right at the threshold.

The fix: never divide. For fl(q) the IEEE rounding of the real quotient
q = num/den,

    fl(q) > t   <=>   q > m        (or q >= m, see tie rule)
    fl(q) < t   <=>   q < m'       (or q <= m')

where m is the *rounding boundary* next to t: the midpoint between t and
nextafter(t) in the comparison direction. Quotients strictly inside
(t, m) round back onto t and fail the strict comparison; quotients beyond
m round past t. A quotient exactly equal to m rounds to whichever
neighbor has an even mantissa (round-to-nearest-even), which makes the
boundary comparison strict when t's mantissa is even and inclusive when
it is odd.

m is computed on host in float64 and decomposed into exact float32 parts;
``q OP m`` is then the sign of ``num - m*den``, evaluated *exactly* on
device using error-free transforms (Dekker two-product + two-sum
distillation) — only IEEE float32 add/sub/mul, no division anywhere. The
products are evaluated as Dekker splits, so the result does not depend
on whether the compiler contracts ``a*b+c`` into a fused multiply-add.

The same machinery with a three-part boundary evaluates *float64*
comparison semantics for integer-valued operands (|num|,|den| < 2^24, so
they are exact float32 values): this serves the integer reflectance path
when a threshold is not an exact decimal fraction (the reference computes
int16/int16 in float64 there), removing the float32 fallback entirely.

Domain: |num| and |m*den| must stay below ~2^126 (no overflow inside the
two-products) and the boundary parts must be exactly representable as
normal float32 values; both hold for reflectance-scaled inputs and for
the int16-derived integer path. Thresholds smaller in magnitude than
~2^-100 (other than exactly 0) are rejected.
"""

import dataclasses
import struct
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

_F32 = jnp.float32


# ---------------------------------------------------------------------------
# Device error-free transforms (IEEE f32 add/sub/mul only)
# ---------------------------------------------------------------------------

def _opaque(x):
    """Hide a rounded intermediate from XLA's algebraic simplifier.

    In large fused graphs XLA reassociates real-arithmetic identities
    like ``a - ((a + b) - b) -> 0`` that destroy error-free transforms
    (observed on XLA:CPU: the TwoSum error term collapsed and
    double-f32 accumulation degraded to plain f32 — context-dependent,
    so small unit graphs survive while bigger fusions break). An
    optimization barrier keeps the compiled arithmetic IEEE-faithful;
    eager semantics are unchanged."""
    import jax
    return jax.lax.optimization_barrier(x)


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b)."""
    s = _opaque(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Veltkamp split of a float32 into two 12-bit halves."""
    c = _opaque(a * _F32(4097.0))  # 2**12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProduct: p + e == a * b exactly (no FMA needed)."""
    p = _opaque(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _exact_sum_sign(components):
    """Sign (-1/0/+1 int32) of the exact real sum of float32 arrays.

    Distills the component list into a nonoverlapping expansion with
    repeated TwoSum sweeps (Ogita-Rump-Oishi style), then reads the sign
    off the leading nonzero term. len(components) sweeps are enough to
    fully distill sums whose exact value spans <= 24*len bits, which
    covers every caller here (verified by the adversarial unit fuzz in
    tests/test_f32exact.py, including exact ties and full cancellation).
    """
    comps = list(components)
    n = len(comps)
    for _ in range(n):
        out = []
        s = comps[0]
        for c in comps[1:]:
            s, e = _two_sum(s, c)
            out.append(e)
        out.append(s)  # leading (largest-magnitude) term last
        comps = out
    sign = jnp.zeros(jnp.shape(comps[-1]), jnp.int32)
    for c in reversed(comps):
        c_sign = jnp.where(c > 0, 1, jnp.where(c < 0, -1, 0)).astype(
            jnp.int32)
        sign = jnp.where(sign != 0, sign, c_sign)
    return sign


# ---------------------------------------------------------------------------
# Host boundary decomposition
# ---------------------------------------------------------------------------

def _mantissa_odd(value) -> bool:
    if isinstance(value, np.float32):
        return bool(struct.unpack('<I', struct.pack('<f', float(value)))[0]
                    & 1)
    return bool(struct.unpack('<Q', struct.pack('<d', float(value)))[0] & 1)


def _f32_parts(m: float, n_parts: int) -> Optional[Tuple[float, ...]]:
    """Exact float32 decomposition of float m, or None if lossy."""
    parts = []
    rem = np.float64(m)
    for _ in range(n_parts):
        p = np.float32(rem)
        if not np.isfinite(p):
            return None
        if p != 0:
            parts.append(float(p))
        rem = np.float64(rem) - np.float64(p)
        if rem == 0:
            break
    if rem != 0:
        return None
    for p in parts:  # a backend may flush subnormal parts to zero
        if abs(p) < 2.0 ** -126:
            return None
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class RatioBoundary:
    """Host-precomputed boundary for fl(num/den) OP t (OP in {gt, lt})."""
    parts: Tuple[float, ...]  # exact f32 parts of the boundary m
    op_gt: bool               # True: original comparison is '>', else '<'
    inclusive: bool           # tie q == m counts as passing
    always: Optional[bool]    # short-circuit (NaN/inf threshold)
    zero_q_result: bool       # result when fl(q) == +-0 (den = +-inf)


def ratio_boundary(t, op: str, precision: str = 'f32') -> RatioBoundary:
    """Decompose threshold t for an exact device-side ratio comparison.

    precision 'f32': semantics of ``np.float32(num)/np.float32(den) OP t``
    as NumPy evaluates it (t participates as float32). precision 'f64':
    semantics of ``float64(num)/float64(den) OP float64(t)`` for
    integer-valued num/den (the reference's unscaled int16 path).
    """
    if op not in ('gt', 'lt'):
        raise ValueError(f'op must be gt or lt, got {op!r}')
    op_gt = op == 'gt'
    tf = np.float32(t) if precision == 'f32' else np.float64(t)
    if np.isnan(tf):
        return RatioBoundary((), op_gt, False, False, False)
    if np.isinf(tf):
        # q > +inf: never; q > -inf: whenever q is not NaN (handled by
        # the caller's NaN mask with always=True); symmetric for '<'.
        always = (tf < 0) if op_gt else (tf > 0)
        return RatioBoundary((), op_gt, False, bool(always), bool(always))
    direction = np.inf if op_gt else -np.inf
    if precision == 'f32':
        tn = np.nextafter(tf, np.float32(direction))
        m = (np.float64(tf) + np.float64(tn)) * 0.5
        n_parts = 2
    else:
        tn = np.nextafter(tf, direction)
        half_ulp = (np.float64(tn) - np.float64(tf)) * 0.5  # exact: +-2^k
        m = None  # assembled from parts below
        n_parts = 4
    inclusive = _mantissa_odd(tf)
    if precision == 'f32':
        parts = _f32_parts(float(m), n_parts)
    else:
        base = _f32_parts(float(tf), 3)
        half = _f32_parts(float(half_ulp), 1)
        parts = None if (base is None or half is None) else base + half
    if parts is None:
        if tf == 0:
            # Boundary is half the smallest subnormal, so the comparison
            # degenerates to sign(q) OP 0. This is exact unless
            # 0 < |num/den| <= 2^-150, which requires |num| subnormal
            # while |den| >= 2 — impossible when num and den are the
            # difference and sum of the same operand pair (MNDWI/NDVI):
            # |den| >= 2 forces |num| >= ulp(1)/2 = 2^-24 when nonzero.
            parts = ()
        else:
            raise ValueError(
                f'threshold {t!r} has no exact normal-f32 boundary '
                f'decomposition (|t| too small or too large)')
    # fl(q) == +-0 compares against t like 0.0 does (signed zeros equal)
    zero_q = bool(np.float32(0) > tf) if op_gt else bool(np.float32(0) < tf)
    return RatioBoundary(tuple(parts), op_gt, inclusive, None, zero_q)


# ---------------------------------------------------------------------------
# Device comparison
# ---------------------------------------------------------------------------

def ratio_cmp(num, den, b: RatioBoundary):
    """Exact ``fl(num/den) OP t`` with full IEEE special-value semantics.

    num, den: float32 arrays (for 'f64' boundaries: integer-valued
    float32 arrays, |.| < 2**24). Returns a bool array bit-identical to
    the NumPy evaluation of the same comparison.
    """
    num = jnp.asarray(num, _F32)
    den = jnp.asarray(den, _F32)
    if b.always is not None:
        # t = +-inf. 'q > -inf' fails only for NaN or -inf quotients
        # (symmetrically for 'q < +inf'); infinite quotients from finite
        # overflowing operands are not modeled — unreachable for any
        # reflectance-domain input.
        base = jnp.full(jnp.broadcast_shapes(num.shape, den.shape),
                        b.always)
        if not b.always:
            return base
        nan_q = (jnp.isnan(num) | jnp.isnan(den)
                 | ((num == 0) & (den == 0))
                 | (jnp.isinf(num) & jnp.isinf(den)))
        inf_q = (((den == 0) & (num != 0)) | jnp.isinf(num)) & ~nan_q
        neg_inf = jnp.logical_xor(jnp.signbit(num), jnp.signbit(den))
        bad_inf = inf_q & (neg_inf if b.op_gt else ~neg_inf)
        return base & ~nan_q & ~bad_inf

    comps = [num]
    for part in b.parts:
        p, e = _two_prod(_F32(part), den)
        comps.extend([-p, -e])
    sign = _exact_sum_sign(comps) if b.parts else jnp.where(
        num > 0, 1, jnp.where(num < 0, -1, 0)).astype(jnp.int32)
    # sign tracks num - m*den; dividing by den flips it when den < 0
    q_cmp = jnp.where(den > 0, sign, -sign)
    if b.inclusive:
        finite_res = (q_cmp >= 0) if b.op_gt else (q_cmp <= 0)
    else:
        finite_res = (q_cmp > 0) if b.op_gt else (q_cmp < 0)

    num_zero = num == 0
    den_zero = den == 0
    nan_q = (jnp.isnan(num) | jnp.isnan(den) | (num_zero & den_zero)
             | (jnp.isinf(num) & jnp.isinf(den)))
    inf_q = ((den_zero & ~num_zero) | jnp.isinf(num)) & ~nan_q
    neg_inf = jnp.logical_xor(jnp.signbit(num), jnp.signbit(den))
    inf_res = ~neg_inf if b.op_gt else neg_inf
    zero_q = jnp.isinf(den) & ~nan_q  # finite/inf -> +-0
    return jnp.where(
        nan_q, False,
        jnp.where(inf_q, inf_res,
                  jnp.where(zero_q, b.zero_q_result, finite_res)))


# ---------------------------------------------------------------------------
# Host integer bounds: ``int_array OP float64_threshold`` as pure int cmp
# ---------------------------------------------------------------------------

def int_gt_bound(t) -> Optional[int]:
    """Smallest integer B with (i > t) == (i >= B); None if never true."""
    tf = np.float64(t)
    if np.isnan(tf) or tf == np.inf:
        return None
    if tf == -np.inf:
        return -(2 ** 62)
    return int(np.floor(tf)) + 1


def int_lt_bound(t) -> Optional[int]:
    """Largest integer B with (i < t) == (i <= B); None if never true."""
    tf = np.float64(t)
    if np.isnan(tf) or tf == -np.inf:
        return None
    if tf == np.inf:
        return 2 ** 62
    ce = np.ceil(tf)
    return int(ce) - 1 if ce == tf else int(np.floor(tf))
