"""dswx_campaign: batched multi-tile production over all local devices.

The scale-out entry point with no reference counterpart (the reference
processes one tile per process): give it many HLS tile directories and it
shards tile batches across all devices with prefetched host I/O, a resume
manifest, and per-tile retry.

Examples:
    dswx_campaign tiles/T15RYP tiles/T15RYN -o out/
    dswx_campaign --tiles-list tiles.txt -o out/ --manifest camp.json
"""

import argparse
import glob
import logging
import os
import sys

from proteus_jax.core.thresholds import HlsThresholds
from proteus_jax.models.dswx.chain import DswxChainConfig
from proteus_jax.runtime.logging_util import create_logger
from proteus_jax.utils import compile_cache

logger = logging.getLogger('dswx_hls')


def get_parser():
    parser = argparse.ArgumentParser(
        description='Batched DSWx-HLS campaign across all devices',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('input_dirs', nargs='*',
                        help='HLS tile directories (one product each)')
    parser.add_argument('--tiles-list', type=str,
                        help='File listing one HLS tile directory per '
                             'line')
    parser.add_argument('-o', '--output-dir', required=True,
                        help='Campaign output directory (one '
                             'subdirectory per tile)')
    parser.add_argument('--manifest', type=str, default=None,
                        help='Campaign manifest JSON (enables '
                             'resume/retry bookkeeping); defaults to '
                             '<output-dir>/campaign_manifest.json')
    parser.add_argument('--product-version', type=str, default='1.0')
    parser.add_argument('--max-retries', type=int, default=2)
    parser.add_argument('--reader-threads', type=int, default=None,
                        help='default: scaled to the host core count')
    parser.add_argument('--writer-threads', type=int, default=None,
                        help='default: scaled to the host core count')
    parser.add_argument('--mask-adjacent-to-cloud-mode', type=str,
                        choices=['mask', 'ignore', 'cover'],
                        default='mask')
    parser.add_argument('--shadow-masking-algorithm', type=str,
                        choices=['sun_local_inc_angle', 'otsu'],
                        default='sun_local_inc_angle',
                        help='Terrain shadow algorithm for the SHAD '
                             'layer (reference shadow_masking_'
                             'algorithm runconfig key)')
    parser.add_argument('--dem', dest='dem_file', type=str,
                        help='Shared DEM covering all tiles (enables the '
                             'SHAD + DEM layers)')
    parser.add_argument('-c', '--landcover', dest='landcover_file',
                        type=str, help='Shared CGLS landcover file')
    parser.add_argument('-w', '--worldcover', dest='worldcover_file',
                        type=str, help='Shared ESA WorldCover file')
    parser.add_argument('-s', '--shoreline',
                        dest='shoreline_shapefile', type=str,
                        help='GSHHS shoreline shapefile (enables ocean '
                             'masking)')
    parser.add_argument('--ocean-masking-distance-km', type=float,
                        default=1.0)
    parser.add_argument('--browse', dest='save_browse',
                        action='store_true', default=False,
                        help='Also produce browse GeoTIFF + PNG per tile')
    parser.add_argument('--scaled', dest='scaled_inputs',
                        action='store_true', default=False,
                        help='Apply per-band scale/offset at ingest and '
                             'run the float32 science chain (reference '
                             'flag_offset_and_scale_inputs)')
    parser.add_argument("--tiles-per-device", type=int, default=1,
                        help="Tiles per device per batch (several tiles "
                             "in one dispatch)")
    parser.add_argument("--spatial-shards", type=int, default=1,
                        help='Shard each tile spatially over this many '
                             'devices (2-D tile x space mesh with halo '
                             'exchange)')
    parser.add_argument('--hosts', type=int, default=1,
                        help='Dispatch the campaign across this many '
                             'worker processes (per-worker manifest '
                             'shards + lost-worker recovery; on GPUs one '
                             'card per worker; see parallel/dispatch.py)')
    parser.add_argument('--debug', dest='flag_debug',
                        action='store_true', default=False,
                        help='Read only 1000x1000 windows')
    parser.add_argument('--stats-json', type=str, default=None,
                        help='Write the final campaign statistics '
                             '(incl. the per-stage core-seconds table '
                             'when PROTEUS_STAGE_TIMES=1) to this '
                             'JSON file')
    parser.add_argument('--log', '--log-file', dest='log_file', type=str)
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    create_logger(args.log_file)
    compile_cache.enable()

    tile_dirs = list(args.input_dirs)
    if args.tiles_list:
        with open(args.tiles_list) as fh:
            tile_dirs += [ln.strip() for ln in fh
                          if ln.strip() and not ln.startswith('#')]
    if not tile_dirs:
        logger.error('ERROR no input tiles given')
        sys.exit(2)

    from proteus_jax.parallel.campaign import CampaignRunner, TileJob

    jobs = []
    for d in tile_dirs:
        files = sorted(glob.glob(os.path.join(d, '*.tif')))
        if not files:
            logger.warning(f'WARNING no .tif files in {d}; skipping')
            continue
        tile_id = os.path.basename(os.path.normpath(d))
        jobs.append(TileJob(
            tile_id, files, os.path.join(args.output_dir, tile_id),
            product_id=tile_id, product_version=args.product_version,
            dem_file=args.dem_file, landcover_file=args.landcover_file,
            worldcover_file=args.worldcover_file,
            shoreline_shapefile=args.shoreline_shapefile,
            ocean_masking_shoreline_distance_km=
            args.ocean_masking_distance_km))

    manifest = args.manifest or os.path.join(args.output_dir,
                                             'campaign_manifest.json')
    os.makedirs(args.output_dir, exist_ok=True)

    if args.hosts > 1:
        from proteus_jax.parallel.dispatch import dispatch_campaign
        _, stats = dispatch_campaign(
            jobs, n_hosts=args.hosts, manifest_path=manifest,
            scratch_dir=os.path.join(args.output_dir, '.dispatch'),
            config_kwargs=dict(
                mask_adjacent_to_cloud_mode=
                args.mask_adjacent_to_cloud_mode,
                shadow_masking_algorithm=
                args.shadow_masking_algorithm),
            save_browse=args.save_browse,
            runner_kwargs=dict(
                max_retries=args.max_retries,
                reader_threads=args.reader_threads,
                writer_threads=args.writer_threads,
                flag_debug=args.flag_debug,
                spatial_shards=args.spatial_shards,
                tiles_per_device=args.tiles_per_device,
                scaled_inputs=args.scaled_inputs))
        logger.info(f'campaign complete: {stats}')
        sys.exit(1 if stats['tiles_failed'] else 0)

    config = DswxChainConfig(
        thresholds=HlsThresholds(),
        mask_adjacent_to_cloud_mode=args.mask_adjacent_to_cloud_mode,
        shadow_masking_algorithm=args.shadow_masking_algorithm)
    runner = CampaignRunner(config=config, manifest_path=manifest,
                            max_retries=args.max_retries,
                            reader_threads=args.reader_threads,
                            writer_threads=args.writer_threads,
                            flag_debug=args.flag_debug,
                            save_browse=args.save_browse,
                            spatial_shards=args.spatial_shards,
                            tiles_per_device=args.tiles_per_device,
                            scaled_inputs=args.scaled_inputs)
    stats = runner.run(jobs)
    logger.info(f'campaign complete: {stats}')
    if args.stats_json:
        import json
        with open(args.stats_json, 'w') as fh:
            json.dump(stats, fh, indent=1)
    if stats['tiles_failed']:
        sys.exit(1)


if __name__ == '__main__':
    main()
