"""End-to-end campaign benchmark: tiles/min through the full pipeline.

Measures what bench.py's science-chain metric does not: ingest (GeoTIFF
decode), per-tile ancillary preparation (ocean mask, DEM warp + terrain
shadow, landcover warps + LAND), the fused device chain, and COG encoding
of every product layer, driven by the production CampaignRunner with its
reader/writer overlap.

Protocol: one warm-up tile absorbs XLA compilation (cached across runs by
the persistent compile cache), then --runs measured passes over --tiles
full-size tiles each; the MEDIAN pass is reported. One JSON line, same
shape as bench.py. Exits non-zero, printing no result, when JAX finds no
GPU.

Usage: python bench_e2e.py [--tiles 8] [--runs 3] [--size 3660]
       [--no-ancillaries]
"""

import argparse
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, 'tests'))


def build_dataset(root, size, ancillaries):
    import synthetic
    in_dir = os.path.join(root, 'in')
    stamp = os.path.join(in_dir, f'.stamp_{size}_{int(ancillaries)}')
    if os.path.exists(stamp):
        extra = {}
        if ancillaries:
            extra = dict(
                dem_file=os.path.join(in_dir, 'dem.tif'),
                landcover_file=os.path.join(in_dir, 'landcover.tif'),
                worldcover_file=os.path.join(in_dir, 'worldcover.tif'),
                shoreline_shapefile=os.path.join(in_dir, 'shoreline.shp'))
        files = sorted(
            os.path.join(in_dir, f) for f in os.listdir(in_dir)
            if f.startswith('HLS.') and f.endswith('.tif'))
        return files, extra
    shutil.rmtree(in_dir, ignore_errors=True)
    os.makedirs(in_dir, exist_ok=True)
    files, _ = synthetic.make_hls_v2_dataset(in_dir, size=size)
    extra = {}
    if ancillaries:
        extra = dict(
            dem_file=synthetic.make_dem(in_dir, size=size),
            landcover_file=synthetic.make_landcover(in_dir, size=size),
            worldcover_file=synthetic.make_worldcover(in_dir, size=size),
            shoreline_shapefile=synthetic.make_shoreline(in_dir,
                                                         size=size))
    open(stamp, 'w').close()
    return files, extra


def run_pass(files, extra, out_root, n_tiles, tag):
    from proteus_jax.models.dswx.chain import DswxChainConfig
    from proteus_jax.parallel.campaign import CampaignRunner, TileJob
    out_dir = os.path.join(out_root, tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    jobs = [TileJob(f'tile{i:03d}', files,
                    os.path.join(out_dir, f'tile{i:03d}'), **extra)
            for i in range(n_tiles)]
    for j in jobs:
        os.makedirs(j.output_dir, exist_ok=True)
    runner = CampaignRunner(
        config=DswxChainConfig(), save_browse=True,
        scaled_inputs=os.environ.get('PROTEUS_BENCH_SCALED') == '1',
        tiles_per_device=int(os.environ.get(
            'PROTEUS_TILES_PER_DEVICE', '1')))
    from proteus_jax.parallel.campaign import STAGE_TIMES
    STAGE_TIMES.reset()  # per-pass stage tables
    t0 = time.time()
    stats = runner.run(jobs)
    dt = time.time() - t0
    if stats['tiles_failed']:
        raise RuntimeError(f'{stats["tiles_failed"]} tiles failed')
    if 'stage_seconds' in stats:
        print(f'# stage core-seconds ({tag}, {n_tiles} tiles):',
              file=sys.stderr)
        for name, rec in stats['stage_seconds'].items():
            print(f'#   {name}: {rec["seconds"]:.1f} s '
                  f'({rec["seconds"] / n_tiles:.2f} s/tile,'
                  f' {rec["calls"]} calls)', file=sys.stderr)
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--tiles', type=int, default=8)
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--size', type=int, default=3660)
    ap.add_argument('--no-ancillaries', action='store_true')
    ap.add_argument('--root', default=os.path.join(HERE, 'profiles',
                                                   'e2e_bench'))
    args = ap.parse_args()

    from proteus_jax.utils import compile_cache
    from proteus_jax.utils.gpu import (NoGpuError, card_identity,
                                       device_record, require_gpu)
    try:
        devices = require_gpu()
    except NoGpuError as exc:
        print(f'bench_e2e.py: {exc}', file=sys.stderr)
        return 2
    compile_cache.enable()

    files, extra = build_dataset(args.root, args.size,
                                 not args.no_ancillaries)
    out_root = os.path.join(args.root, 'out')

    # warm-up: compile + caches
    run_pass(files, extra, out_root, 1, 'warm')

    times = []
    for r in range(args.runs):
        dt = run_pass(files, extra, out_root, args.tiles, f'run{r}')
        times.append(dt)
        print(f'# pass {r}: {args.tiles} tiles in {dt:.1f} s '
              f'({args.tiles / dt * 60:.2f} tiles/min)', file=sys.stderr)
    times.sort()
    med = times[len(times) // 2]
    tpm = args.tiles / med * 60.0
    scaled_tag = '_scaled' \
        if os.environ.get('PROTEUS_BENCH_SCALED') == '1' else ''
    print(json.dumps({
        'metric': f'e2e_campaign_tiles_per_min_{args.size}x{args.size}'
                  + ('' if args.no_ancillaries else '_all_ancillaries')
                  + scaled_tag,
        'value': tpm,
        'unit': 'tiles/min',
        'n_passes': args.runs,
        'pass_seconds': times,
        'device': device_record(devices),
        'card': card_identity(),
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
