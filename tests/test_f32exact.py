"""Adversarial verification of the division-free exact ratio comparisons.

Ground truth is the host's IEEE evaluation: NumPy float32 division for the
scaled-input ('f32') semantics and NumPy float64 division for the integer
('f64') semantics — exactly what the reference's executing code computes
(dswx_hls.py:1872-1884 over float32 scaled arrays / int16 arrays).
"""

import numpy as np
import pytest

import jax

from proteus_jax.core.f32exact import (int_gt_bound, int_lt_bound,
                                       ratio_boundary, ratio_cmp)

DEFAULT_RATIO_THRESHOLDS = [0.124, -0.44, 0.7, -0.5, 0.0]


def _host_f32_cmp(num, den, t, op):
    with np.errstate(divide='ignore', invalid='ignore'):
        q = num.astype(np.float32) / den.astype(np.float32)
    t32 = np.float32(t)
    return (q > t32) if op == 'gt' else (q < t32)


def _host_f64_cmp(num, den, t, op):
    with np.errstate(divide='ignore', invalid='ignore'):
        q = num.astype(np.float64) / den.astype(np.float64)
    t64 = np.float64(t)
    return (q > t64) if op == 'gt' else (q < t64)


def _run(num, den, t, op, precision='f32'):
    b = ratio_boundary(t, op, precision)
    fn = jax.jit(lambda n, d: ratio_cmp(n, d, b))
    return np.asarray(fn(num.astype(np.float32), den.astype(np.float32)))


class TestF32RatioCmp:
    """fl32(num/den) OP t over the scaled-reflectance domain."""

    def _assert_matches(self, num, den, t, op):
        got = _run(num, den, t, op, 'f32')
        want = _host_f32_cmp(num, den, t, op)
        mism = got != want
        assert not mism.any(), (
            f't={t} op={op}: {mism.sum()} mismatches, first at '
            f'num={num[mism][0]!r} den={den[mism][0]!r}')

    @pytest.mark.parametrize('t', DEFAULT_RATIO_THRESHOLDS)
    @pytest.mark.parametrize('op', ['gt', 'lt'])
    def test_boundary_adjacent_quotients(self, t, op):
        """num engineered so num/den straddles the rounding boundary."""
        rng = np.random.default_rng(hash((t, op)) % 2 ** 31)
        n = 20000
        den = ((rng.random(n) * 13.2 - 6.6)
               .astype(np.float32))
        den[den == 0] = np.float32(1e-4)
        t32 = np.float32(t)
        direction = np.float32(np.inf if op == 'gt' else -np.inf)
        tn = np.nextafter(t32, direction)
        m = (np.float64(t32) + np.float64(tn)) * 0.5
        base = (m * den.astype(np.float64)).astype(np.float32)
        nums = [base]
        for _ in range(3):
            base = np.nextafter(base, np.float32(np.inf))
            nums.append(base.copy())
        base = nums[0]
        for _ in range(3):
            base = np.nextafter(base, np.float32(-np.inf))
            nums.append(base.copy())
        num = np.concatenate(nums)
        den_full = np.tile(den, len(nums))
        if t == 0.0:
            # sign(q)-vs-0 is exact only when num/den are the difference
            # and sum of one operand pair (the MNDWI/NDVI shape); the
            # boundary construction above lands in the excluded subnormal
            # corner, so exercise the pair construction instead.
            g = (rng.random(n).astype(np.float32) * 13.2 - 6.6)
            s = g + (rng.random(n).astype(np.float32) - 0.5) * np.exp2(
                rng.integers(-24, 4, n)).astype(np.float32)
            num, den_full = g - s, g + s
        self._assert_matches(num, den_full, t, op)

    @pytest.mark.parametrize('t', DEFAULT_RATIO_THRESHOLDS + [1 / 3,
                                                              0.1237])
    def test_random_domain(self, t):
        rng = np.random.default_rng(7)
        n = 100000
        num = (rng.random(n).astype(np.float32) * 13.2 - 6.6)
        den = (rng.random(n).astype(np.float32) * 13.2 - 6.6)
        for op in ('gt', 'lt'):
            self._assert_matches(num, den, t, op)

    def test_special_values(self):
        num = np.array([0.0, -0.0, 1.0, -1.0, 0.0, np.nan, np.inf,
                        -np.inf, 1.0, np.inf, 2.0, -3.0, 0.0],
                       dtype=np.float32)
        den = np.array([0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0,
                        np.nan, np.inf, -0.0, np.inf, -2.0],
                       dtype=np.float32)
        for t in (0.124, -0.44, 0.0):
            for op in ('gt', 'lt'):
                self._assert_matches(num, den, t, op)

    def test_infinite_threshold(self):
        num = np.array([1.0, -1.0, np.nan, 0.0, 2.0], dtype=np.float32)
        den = np.array([2.0, 2.0, 1.0, 0.0, -0.0], dtype=np.float32)
        for t, op in [(np.inf, 'gt'), (-np.inf, 'gt'),
                      (np.inf, 'lt'), (-np.inf, 'lt')]:
            self._assert_matches(num, den, float(t), op)

    def test_nan_threshold(self):
        num = np.array([1.0, -1.0], dtype=np.float32)
        den = np.array([2.0, 2.0], dtype=np.float32)
        for op in ('gt', 'lt'):
            assert not _run(num, den, float('nan'), op, 'f32').any()

    def test_tiny_threshold_rejected(self):
        with pytest.raises(ValueError):
            ratio_boundary(1e-40, 'gt', 'f32')

    def test_tiny_threshold_chain_fallback(self):
        # a legal-but-pathological runconfig threshold (|t| ~< 1e-30 has
        # no normal-f32 boundary decomposition) must not crash the jnp
        # diagnostic chain: it falls back to an approximate f32 division
        # compare (ADVICE round 2)
        from proteus_jax.core.thresholds import HlsThresholds
        from proteus_jax.models.dswx.diagnostics import \
            compute_diagnostic_tests
        rng = np.random.default_rng(7)
        t = HlsThresholds(wigt=1e-35, awgt=0.0, pswt_1_mndwi=-1e-32,
                          pswt_1_nir=1500, pswt_1_swir1=900,
                          pswt_1_ndvi=0.7, pswt_2_mndwi=-0.5,
                          pswt_2_blue=1000, pswt_2_nir=2500,
                          pswt_2_swir1=3000, pswt_2_swir2=1000,
                          lcmask_nir=1200)
        shape = (16, 16)
        ibands = [rng.integers(-2000, 18000, shape).astype(np.int16)
                  for _ in range(6)]
        diag_i = np.asarray(compute_diagnostic_tests(*ibands, t))
        fbands = [(0.0001 * b).astype(np.float32) for b in ibands]
        diag_f = np.asarray(compute_diagnostic_tests(*fbands, t))
        assert diag_i.shape == shape and diag_f.shape == shape
        # at these magnitudes the division compare reduces to a sign
        # test: the smallest nonzero |num/den| here is 1/65535 >> 1e-35,
        # so a float64 oracle division agrees exactly
        g, s1 = ibands[1].astype(np.int64), ibands[4].astype(np.int64)
        num = ((g - s1) % 65536 + 32768) % 65536 - 32768
        den = ((g + s1) % 65536 + 32768) % 65536 - 32768
        with np.errstate(divide='ignore', invalid='ignore'):
            q = num / den
        expect_t1 = q > 1e-35
        got_t1 = (diag_i & 1) == 1
        assert (got_t1 == expect_t1).all()


class TestF64IntRatioCmp:
    """float64 semantics for int16-derived numerators/denominators."""

    @pytest.mark.parametrize('t', [1 / 3, 0.124 + 1e-12, -0.44, 0.7,
                                   -2 / 7, 0.1, 123.456])
    @pytest.mark.parametrize('op', ['gt', 'lt'])
    def test_boundary_adjacent(self, t, op):
        rng = np.random.default_rng(hash((t, op)) % 2 ** 31)
        n = 20000
        den = rng.integers(-65534, 65535, n).astype(np.float64)
        den[den == 0] = 3.0
        t64 = np.float64(t)
        tn = np.nextafter(t64, np.inf if op == 'gt' else -np.inf)
        m = t64 + (tn - t64) * 0.5
        # integer numerators bracketing m*den: floor/ceil and +-1 around
        base = np.floor(m * den)
        num = np.concatenate([base + k for k in (-1, 0, 1, 2)])
        den_full = np.tile(den, 4)
        got = _run(num, den_full, t, op, 'f64')
        want = _host_f64_cmp(num, den_full, t, op)
        assert np.array_equal(got, want)

    def test_random_and_specials(self):
        rng = np.random.default_rng(11)
        n = 50000
        num = rng.integers(-131068, 131069, n).astype(np.float64)
        den = rng.integers(-131068, 131069, n).astype(np.float64)
        num[:10] = 0
        den[5:15] = 0
        for t in (1 / 3, -0.44, 0.0):
            for op in ('gt', 'lt'):
                got = _run(num, den, t, op, 'f64')
                want = _host_f64_cmp(num, den, t, op)
                assert np.array_equal(got, want), (t, op)

    def test_exact_tie_integer_ratio(self):
        """Quotients landing exactly on a representable threshold."""
        num = np.array([1, 2, 3, -1, -3, 6], dtype=np.float64)
        den = np.array([2, 4, 6, 2, -6, 12], dtype=np.float64)
        for t in (0.5, -0.5):
            for op in ('gt', 'lt'):
                got = _run(num, den, t, op, 'f64')
                want = _host_f64_cmp(num, den, t, op)
                assert np.array_equal(got, want), (t, op)


class TestIntBounds:
    @pytest.mark.parametrize('t', [900.0, 900.5, -900.5, 0.3, -0.3, 0.0,
                                   1e-9, -1e-9, 1234.0000001, 32767.9])
    def test_bounds_match_float64_comparison(self, t):
        i = np.arange(-33000, 33000)
        gt = int_gt_bound(t)
        lt = int_lt_bound(t)
        assert np.array_equal(i >= gt, i > np.float64(t))
        assert np.array_equal(i <= lt, i < np.float64(t))

    def test_non_finite(self):
        assert int_gt_bound(float('nan')) is None
        assert int_gt_bound(float('inf')) is None
        assert int_lt_bound(float('-inf')) is None
        i = np.arange(-10, 10)
        assert (i >= int_gt_bound(float('-inf'))).all()
        assert (i <= int_lt_bound(float('inf'))).all()
