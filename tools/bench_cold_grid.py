"""Cold- vs warm-ancillary-grid campaign benchmark.

A campaign whose tiles all share one MGRS grid runs warm: the per-grid
DEM warp, terrain products, landcover warps, and ocean rasterization are
paid once and then served from `_AncillaryCache`. A continental
campaign visits thousands of distinct grids — each tile pays the full
ancillary bill. This tool records BOTH regimes on hardware:

  cold   N tiles on N DISTINCT product grids (origin-shifted), each
         with its own ancillary set -> every `_AncillaryCache` key
         misses; stage attribution shows where the cold cost lands.
  warm   N revisits of ONE grid sharing one ancillary set (the round-3
         soak/bench shape) -> first tile cold, N-1 warm hits.

Both runs drive `CampaignRunner` in-process (per-tile ancillary files
need `TileJob`'s per-job fields, which the CLI's shared --dem surface
does not expose) with PROTEUS_STAGE_TIMES=1, identical runner
settings, and a cleared cache, then write profiles/cold_grid_bench.json
with tiles/min + the per-stage core-seconds table for each.

Reference match: the per-tile `_warp` calls at
/root/reference/src/proteus/dswx_hls.py:5145,5196 — the reference pays
the full ancillary bill on EVERY tile (it has no cross-tile process),
so its throughput is our cold row by construction.

    python tools/bench_cold_grid.py [--tiles 16] [--size 3660]
                                    [--keep-data] [--skip-warm]

Small sizes (--size 512) rehearse the harness on CPU.
"""

import argparse
import glob
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))


def build_cold(root, n, size):
    """n granules on n distinct product grids (2 x ceil(n/2) origin
    raster, ~1.25 tile pitches apart -> disjoint extents, all inside
    UTM zone 15N), each with its own ancillary set."""
    import synthetic
    x0, y0 = synthetic.X0, synthetic.Y0
    pitch = 1.25 * size * abs(synthetic.DX)
    tiles = []
    try:
        for t in range(n):
            gx, gy = t % 2, t // 2
            synthetic.X0 = x0 + (gx - 0.5) * pitch
            synthetic.Y0 = y0 + (gy - (n + 1) // 4) * pitch
            d = os.path.join(root, f'cold_{t:02d}')
            anc = os.path.join(d, 'anc')
            stamp = os.path.join(d, '.done')
            if not os.path.isfile(stamp):
                os.makedirs(anc, exist_ok=True)
                synthetic.make_hls_v2_dataset(d, size=size,
                                              seed=7000 + t)
                synthetic.make_dem(anc, size=size, seed=70 + t)
                synthetic.make_landcover(anc, size=size, seed=71 + t)
                synthetic.make_worldcover(anc, size=size, seed=72 + t)
                synthetic.make_shoreline(anc, size=size)
                open(stamp, 'w').close()
            tiles.append((d, anc))
    finally:
        synthetic.X0, synthetic.Y0 = x0, y0
    return tiles


def build_warm(root, n, size):
    """n granules sharing ONE grid + one ancillary set (the time-series
    revisit pattern the round-3 artifacts measured)."""
    import synthetic
    anc = os.path.join(root, 'anc')
    os.makedirs(anc, exist_ok=True)
    stamp = os.path.join(root, '.anc_done')
    if not os.path.isfile(stamp):
        synthetic.make_dem(anc, size=size)
        synthetic.make_landcover(anc, size=size)
        synthetic.make_worldcover(anc, size=size)
        synthetic.make_shoreline(anc, size=size)
        open(stamp, 'w').close()
    tiles = []
    for t in range(n):
        d = os.path.join(root, f'warm_{t:02d}')
        stamp = os.path.join(d, '.done')
        if not os.path.isfile(stamp):
            synthetic.make_hls_v2_dataset(d, size=size, seed=7000 + t)
            open(stamp, 'w').close()
        tiles.append((d, anc))
    return tiles


def run_campaign(tiles, out_root, label):
    from proteus_jax.core.thresholds import HlsThresholds
    from proteus_jax.models.dswx.chain import DswxChainConfig
    from proteus_jax.parallel import campaign as cmod

    cmod.ANCILLARY_CACHE.clear()
    cmod.STAGE_TIMES.reset()
    jobs = []
    for d, anc in tiles:
        files = sorted(f for f in glob.glob(os.path.join(d, '*.tif')))
        tid = os.path.basename(d)
        jobs.append(cmod.TileJob(
            tid, files, os.path.join(out_root, label, tid),
            product_id=tid,
            dem_file=os.path.join(anc, 'dem.tif'),
            landcover_file=os.path.join(anc, 'landcover.tif'),
            worldcover_file=os.path.join(anc, 'worldcover.tif'),
            shoreline_shapefile=os.path.join(anc, 'shoreline.shp')))
    config = DswxChainConfig(thresholds=HlsThresholds())
    runner = cmod.CampaignRunner(
        config=config,
        manifest_path=os.path.join(out_root, f'manifest_{label}.json'))
    t0 = time.perf_counter()
    stats = runner.run(jobs)
    dt = time.perf_counter() - t0
    if stats['tiles_failed']:
        raise RuntimeError(f'{label}: {stats["tiles_failed"]} tiles '
                           'failed')
    row = {'tiles': len(tiles), 'seconds': round(dt, 1),
           'tiles_per_min': round(60.0 * len(tiles) / dt, 2),
           'stage_seconds': stats.get('stage_seconds', {})}
    print(json.dumps({'label': label, **row}), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--tiles', type=int, default=16)
    ap.add_argument('--size', type=int, default=3660)
    ap.add_argument('--root', default=os.path.join(REPO, 'profiles',
                                                   'cold_grid'))
    ap.add_argument('--out', default=os.path.join(
        REPO, 'profiles', 'cold_grid_bench.json'))
    ap.add_argument('--keep-data', action='store_true')
    ap.add_argument('--skip-warm', action='store_true',
                    help='cold run only (reuse a recorded warm row)')
    args = ap.parse_args()
    os.environ['PROTEUS_STAGE_TIMES'] = '1'

    import jax
    report = {'generated': time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                         time.gmtime()),
              'device': jax.devices()[0].device_kind,
              'tiles': args.tiles, 'size': args.size}

    t0 = time.perf_counter()
    cold = build_cold(args.root, args.tiles, args.size)
    print(json.dumps({'built': 'cold',
                      's': round(time.perf_counter() - t0, 1)}),
          flush=True)
    report['cold'] = run_campaign(cold, args.root, 'cold')

    if not args.skip_warm:
        t0 = time.perf_counter()
        warm = build_warm(args.root, args.tiles, args.size)
        print(json.dumps({'built': 'warm',
                          's': round(time.perf_counter() - t0, 1)}),
              flush=True)
        report['warm'] = run_campaign(warm, args.root, 'warm')
        report['cold_over_warm_ratio'] = round(
            report['warm']['tiles_per_min']
            / report['cold']['tiles_per_min'], 2)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({'artifact': os.path.basename(args.out)}))
    if not args.keep_data:
        shutil.rmtree(args.root, ignore_errors=True)


if __name__ == '__main__':
    main()
