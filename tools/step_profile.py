"""Time the campaign's science step (the jitted XLA chain) on one GPU.

For each cloud-adjacent mode ('mask', 'ignore', 'cover') and for scaled
reflectance (device scale cast), at one 3660 x 3660 tile per step with
every ancillary mask:

- times ``--steps`` calls on device-resident inputs, cycling through
  ``--inputs`` distinct input sets so that consecutive calls never see the
  same data, each call ended by ``block_until_ready``; prints the median;
- traces ``--trace-steps`` further calls with ``jax.profiler`` and reads
  the device planes of the trace: events per step on each device line
  (kernels and copies on the stream lines), the most frequent kernel
  names, and the stream busy time per step;
- reads the bytes XLA's cost analysis assigns to the compiled step;
- compares the step with its floor: the bytes it must read and write,
  from the shapes of its inputs and outputs, at the card's HBM rate.

Prints one JSON line per mode.
Exits non-zero, printing no result, when JAX finds no GPU.

    python tools/step_profile.py [--size 3660] [--out profiles/step_profile]
"""

import argparse
import glob
import json
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# HBM bytes/s by JAX device_kind (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = {'NVIDIA H100 80GB HBM3': 3.35e12}


def make_inputs(rng, size, scaled):
    shape = (1, size, size)
    bands = [np.clip(rng.integers(-2000, 15000, shape), 1,
                     None).astype(np.int16) for _ in range(6)]
    fmask = rng.integers(0, 256, shape).astype(np.uint8)
    invalid = rng.random(shape) < 0.02
    extra = []
    if scaled:
        extra = [np.full((1, 6), 0.0001, np.float32),
                 np.zeros((1, 6), np.float32)]
    ocean = (rng.random(shape) < 0.9).astype(np.uint8)
    shadow = (rng.random(shape) < 0.8).astype(np.uint8)
    land = rng.choice(np.array([0, 100, 200, 201, 255], np.uint8), shape)
    return bands + [fmask, invalid] + extra + [ocean, shadow, land]


def floor_bytes(args, out):
    """Bytes the step must move at least: every input read once, every
    output written once."""
    import jax
    leaves = list(args) + jax.tree_util.tree_leaves(out)
    return int(sum(np.dtype(a.dtype).itemsize * int(np.prod(a.shape))
                   for a in leaves))


def cost_bytes(compiled):
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    value = (cost or {}).get('bytes accessed')
    return None if value is None else float(value)


def read_trace(trace_dir, n_steps):
    """Per-step event counts and stream busy time on the GPU planes."""
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, '**', '*.xplane.pb'),
                      recursive=True)
    if not paths:
        return {'error': 'no xplane file'}
    data = ProfileData.from_file(paths[0])
    per_line = {}
    intervals = []
    for plane in data.planes:
        if not plane.name.startswith('/device:GPU'):
            continue
        for line in plane.lines:
            events = list(line.events)
            names = {}
            for ev in events:
                names[ev.name] = names.get(ev.name, 0) + 1
            per_line[line.name] = {
                'events_per_step': len(events) / n_steps,
                'device_ms_per_step': sum(ev.duration_ns for ev in events)
                / n_steps / 1e6,
                'top_events': sorted(names.items(),
                                     key=lambda kv: -kv[1])[:12]}
            if line.name.startswith('Stream'):
                intervals += [(ev.start_ns, ev.start_ns + ev.duration_ns)
                              for ev in events]
    busy = 0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {'lines': per_line,
            'stream_busy_ms_per_step': busy / n_steps / 1e6}


def profile_mode(mode, size, n_inputs, n_steps, trace_steps, trace_dir):
    import jax
    from proteus_jax.models.dswx.chain import DswxChainConfig
    from proteus_jax.parallel.campaign import make_campaign_step
    from proteus_jax.parallel.mesh import make_tile_mesh
    scaled = mode == 'scaled'
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=(
        'mask' if scaled else mode))
    mesh = make_tile_mesh(jax.devices()[:1])
    step = make_campaign_step(cfg, mesh, with_ocean=True, with_shadow=True,
                              with_landcover=True, float_inputs=scaled,
                              device_scale=scaled)
    rng = np.random.default_rng(17)
    sets = [[jax.device_put(a) for a in make_inputs(rng, size, scaled)]
            for _ in range(n_inputs)]
    jax.block_until_ready(sets)
    t0 = time.perf_counter()
    compiled = step.lower(*sets[0]).compile()
    compile_s = time.perf_counter() - t0
    out = compiled(*sets[0])
    jax.block_until_ready(out)
    for k in range(1, n_inputs):
        jax.block_until_ready(compiled(*sets[k]))
    times = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*sets[i % n_inputs]))
        times.append(time.perf_counter() - t0)
    mode_dir = os.path.join(trace_dir, mode)
    shutil.rmtree(mode_dir, ignore_errors=True)
    with jax.profiler.trace(mode_dir):
        for i in range(trace_steps):
            with jax.profiler.StepTraceAnnotation('campaign_step',
                                                  step_num=i):
                jax.block_until_ready(compiled(*sets[i % n_inputs]))
    trace = read_trace(mode_dir, trace_steps)
    kind = jax.devices()[0].device_kind
    fbytes = floor_bytes(sets[0], out)
    median = float(np.median(times))
    rate = HBM_BYTES_PER_S.get(kind)
    record = {'mode': mode, 'tiles_per_step': 1, 'size': size,
              'compile_seconds': compile_s,
              'step_seconds_median': median,
              'step_seconds_min': float(min(times)),
              'steps_timed': n_steps, 'distinct_inputs': n_inputs,
              'floor_bytes': fbytes,
              'floor_bytes_per_px': fbytes / size ** 2,
              'xla_cost_bytes_accessed': cost_bytes(compiled),
              'floor_seconds': fbytes / rate if rate else None,
              'step_over_floor': median * rate / fbytes if rate else None,
              'hbm_rate_source': (f'{rate:.3g} B/s, NVIDIA data sheet'
                                  if rate else
                                  f'device kind {kind!r} not in the table'),
              'trace': trace}
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--size', type=int, default=3660)
    ap.add_argument('--modes', default='mask,ignore,cover,scaled')
    ap.add_argument('--inputs', type=int, default=3)
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--trace-steps', type=int, default=5)
    ap.add_argument('--out', default=os.path.join(HERE, 'profiles',
                                                  'step_profile'))
    args = ap.parse_args(argv)

    from proteus_jax.utils import compile_cache
    from proteus_jax.utils.gpu import (NoGpuError, card_identity,
                                       device_record, require_gpu)
    try:
        devices = require_gpu()
    except NoGpuError as exc:
        print(f'step_profile.py: {exc}', file=sys.stderr)
        return 2
    compile_cache.enable()
    card = card_identity()
    for mode in args.modes.split(','):
        record = profile_mode(mode, args.size, args.inputs, args.steps,
                              args.trace_steps, args.out)
        record['device'] = device_record(devices[:1])
        record['card'] = card
        print(json.dumps(record), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
