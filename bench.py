"""Benchmark: the DSWx-HLS science step (the jitted XLA chain) on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Methodology: K iterations x B distinct full-chain evaluations (3660 x
3660 int16 bands -> all product layers) run inside ONE jit-compiled
on-device fori_loop with a data dependency between iterations, ended by
a scalar fetch. The median of PROTEUS_BENCH_PASSES timing passes is
reported. The baseline is the reference-equivalent NumPy float64
implementation of the same chain on the host (the reference publishes no
numbers — BASELINE.md — and its execution model is single-process NumPy).
Exits non-zero, printing no result, when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    from proteus_jax.utils.gpu import (NoGpuError, card_identity,
                                       device_record, require_gpu)
    try:
        devices = require_gpu()
    except NoGpuError as exc:
        print(f'bench.py: {exc}', file=sys.stderr)
        return 2

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'tests'))
    import oracle

    from proteus_jax.core.thresholds import HlsThresholds
    from proteus_jax.models.dswx.chain import DswxChainConfig, dswx_chain

    H = W = 3660
    rng = np.random.default_rng(0)
    bands = [np.clip(rng.integers(-2000, 15000, (H, W)), 1,
                     None).astype(np.int16) for _ in range(6)]
    fmask = rng.integers(0, 256, (H, W)).astype(np.uint8)
    invalid = rng.random((H, W)) < 0.02

    # --- baseline: reference-equivalent NumPy float64 chain ----------------
    t = HlsThresholds()
    tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
    lists = {0: [224, 160, 96], 2: [224, 160, 96],
             3: [224, 192, 160, 128, 96], 4: [224, 192, 160, 128, 96]}
    t0 = time.time()
    oracle.full_chain(*bands, fmask, invalid, tdict, mode='mask',
                      aerosol_lists=lists)
    baseline_s = time.time() - t0
    baseline_tiles_per_min = 60.0 / baseline_s

    # --- device: K chained chains in one dispatch ---------------------------
    config = DswxChainConfig()
    # PROTEUS_BENCH_FLOAT=1: bench the scaled-reflectance (float32) mode
    bench_float = os.environ.get('PROTEUS_BENCH_FLOAT') == '1'
    if bench_float:
        bands = [np.float32(0.0001) * b.astype(np.float32)
                 for b in bands]
    # B distinct tiles per dispatch (the campaign's tiles_per_device
    # execution pattern): band-rolled copies of one tile
    B = int(os.environ.get('PROTEUS_BENCH_TILES_PER_DISPATCH', '1'))
    host = bands + [fmask, invalid]
    dev = [jax.device_put(np.stack([np.roll(a, i, axis=0)
                                    for i in range(B)]))
           for a in host]
    jax.block_until_ready(dev)
    K = int(os.environ.get('PROTEUS_BENCH_ITERS', '4'))
    N_PASSES = int(os.environ.get('PROTEUS_BENCH_PASSES', '3'))

    def one(k, arrays):
        acc = jnp.int32(0)
        for i in range(B):
            b = arrays[0][i] + k.astype(arrays[0].dtype)
            out = dswx_chain(b, *[a[i] for a in arrays[1:]], config)
            acc = acc + sum(jnp.sum(v.astype(jnp.int32))
                            for v in out.values()
                            if hasattr(v, 'ndim') and v.ndim == 2)
        return acc

    @jax.jit
    def loop(*a):
        def body(k, acc):
            return acc + one(k, a)
        return jax.lax.fori_loop(0, K, body, jnp.int32(0))

    _ = int(loop(*dev))  # compile + first run, forced by the scalar fetch
    per_tile = []
    for _p in range(N_PASSES):
        t0 = time.time()
        _ = int(loop(*dev))
        per_tile.append((time.time() - t0) / K / B)
    per_tile.sort()
    device_s = per_tile[len(per_tile) // 2]  # median of N passes
    tiles_per_min = 60.0 / device_s

    record = {
        'metric': 'full_chain_tiles_per_min_3660x3660',
        'value': tiles_per_min,
        'unit': 'tiles/min',
        'vs_baseline': tiles_per_min / baseline_tiles_per_min,
        'tiles_per_dispatch': B,
        'n_passes': N_PASSES,
        'pass_s_per_tile': per_tile,
        'device': device_record(devices),
        'card': card_identity(),
    }
    if bench_float:
        record['scaled_float_inputs'] = True
    print(json.dumps(record))
    return 0


if __name__ == '__main__':
    sys.exit(main())
