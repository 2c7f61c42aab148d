"""Multi-process campaign dispatch.

The single-process CampaignRunner shards a tile batch over the devices one
process sees. This module scales the campaign across processes: tiles are
deterministically partitioned per host, each host runs its own
CampaignRunner against a per-host manifest shard (single-writer ledgers —
no cross-host file locking, works on shared filesystems and object
stores), and the dispatcher merges shards, reassigns the tiles of dead or
straggling hosts, and reports campaign statistics.

Two deployment shapes:

- **jax.distributed pod**: every host runs the same program;
  ``host_shard(jobs, jax.process_index(), jax.process_count())`` selects
  its tiles and ``merge_manifests`` + a second pass pick up any failures.
  Tiles are independent, so no collective crosses hosts — only the
  manifest files do.
- **local dispatcher** (also the integration-test harness):
  ``dispatch_campaign`` spawns one worker subprocess per worker slot and
  supervises them. On a GPU machine each worker gets its own card
  (``CUDA_VISIBLE_DEVICES``): a JAX process reserves most of a card's
  memory when it starts, so two workers on one card would fail.

The reference has no distributed execution of any kind (SURVEY.md §2);
this subsystem is the scale-out committed to there.
"""

import json
import logging
import os
import subprocess
import sys

from proteus_jax.parallel.campaign import CampaignManifest, TileJob

logger = logging.getLogger('dswx_hls')

_JOB_FIELDS = ('tile_id', 'input_files', 'output_dir', 'product_id',
               'product_version', 'dem_file', 'landcover_file',
               'worldcover_file', 'shoreline_shapefile',
               'ocean_masking_shoreline_distance_km')


def host_shard(jobs, process_index, process_count):
    """Deterministic round-robin partition of jobs for one host.

    Round-robin (not contiguous chunks) so geographic batches — which
    correlate with ancillary-warp cost — spread evenly across hosts.
    """
    return [j for k, j in enumerate(jobs)
            if k % process_count == process_index]


def host_manifest_path(manifest_path, process_index):
    root, ext = os.path.splitext(manifest_path)
    return f'{root}.host{process_index}{ext or ".json"}'


def merge_manifests(manifest_path, process_count):
    """Merge per-host manifest shards into one CampaignManifest state."""
    merged = CampaignManifest(None)
    for k in range(process_count):
        shard = CampaignManifest(host_manifest_path(manifest_path, k))
        for tile_id, entry in shard.state.items():
            cur = merged.state.get(tile_id)
            if cur is None or entry.get('status') == 'done':
                merged.state[tile_id] = entry
    return merged


def job_to_dict(job):
    return {f: getattr(job, f) for f in _JOB_FIELDS}


def job_from_dict(d):
    return TileJob(**d)


def visible_gpus():
    """Ids of the NVIDIA cards this process may hand to workers.

    ``CUDA_VISIBLE_DEVICES`` when it is set, else the indices that
    ``nvidia-smi`` lists; empty when the machine has no card. Counted
    without JAX, so the dispatcher itself never claims a card."""
    env = os.environ.get('CUDA_VISIBLE_DEVICES')
    if env is not None:
        return [d.strip() for d in env.split(',') if d.strip()]
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=index', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def worker_envs(n_workers, platform=None, gpus=None):
    """Per-worker environment overrides: one card per worker on a GPU.

    With ``platform`` 'cpu' (or ``JAX_PLATFORMS=cpu``) or no card, the
    workers share the default backend and get no override. Otherwise
    worker k sees only card ``gpus[k]``; more workers than cards is
    refused."""
    platform = platform or os.environ.get('JAX_PLATFORMS', '')
    if platform == 'cpu':
        return [{} for _ in range(n_workers)]
    gpus = visible_gpus() if gpus is None else list(gpus)
    if not gpus:
        return [{} for _ in range(n_workers)]
    if n_workers > len(gpus):
        raise ValueError(f'{n_workers} workers but {len(gpus)} GPUs: a '
                         'worker needs a card of its own')
    return [{'CUDA_VISIBLE_DEVICES': gpus[k]} for k in range(n_workers)]


def run_host_worker(spec_path):
    """Entry point of one worker process: process the spec's job list.

    The spec's platform, if any, is applied before JAX initializes a
    backend.
    """
    with open(spec_path) as fh:
        spec = json.load(fh)
    platform = spec.get('platform')
    if platform:
        import jax
        jax.config.update('jax_platforms', platform)
    from proteus_jax.models.dswx.chain import DswxChainConfig
    from proteus_jax.parallel.campaign import CampaignRunner
    jobs = [job_from_dict(d) for d in spec['jobs']]
    for j in jobs:
        os.makedirs(j.output_dir, exist_ok=True)
    runner = CampaignRunner(
        config=DswxChainConfig(**spec.get('config_kwargs', {})),
        manifest_path=spec['manifest_path'],
        save_browse=spec.get('save_browse', False),
        **spec.get('runner_kwargs', {}))
    stats = runner.run(jobs)
    print(json.dumps({'worker_stats': stats}))
    return 0 if stats['tiles_failed'] == 0 else 1


def dispatch_campaign(jobs, n_hosts, manifest_path, scratch_dir,
                      config_kwargs=None, save_browse=False,
                      platform=None, timeout=3600, max_host_failures=1,
                      runner_kwargs=None):
    """Run a campaign across ``n_hosts`` worker processes.

    Each worker gets a deterministic shard, its own manifest file and, on
    a GPU machine, its own card (``worker_envs``).
    After all workers exit, tiles that are not 'done' (worker crashes,
    lost or hung hosts — the latter killed after ``timeout``) are re-run
    in-process up to ``max_host_failures`` times. ``runner_kwargs``
    (spatial_shards, tiles_per_device, flag_debug, reader/writer
    threads, ...) pass through to every worker's CampaignRunner.
    Returns the merged manifest and aggregate statistics.
    """
    os.makedirs(scratch_dir, exist_ok=True)
    envs = worker_envs(n_hosts, platform)

    def launch(pending_jobs, n_workers, round_idx):
        procs = []
        for k in range(n_workers):
            shard = host_shard(pending_jobs, k, n_workers)
            if not shard:
                continue
            spec = {
                'jobs': [job_to_dict(j) for j in shard],
                'manifest_path': host_manifest_path(manifest_path, k),
                'config_kwargs': config_kwargs or {},
                'save_browse': save_browse,
                'platform': platform,
                'runner_kwargs': runner_kwargs or {},
            }
            spec_path = os.path.join(scratch_dir,
                                     f'host{k}_r{round_idx}.json')
            with open(spec_path, 'w') as fh:
                json.dump(spec, fh)
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'proteus_jax.parallel.dispatch',
                 spec_path], env={**os.environ, **envs[k]}))
        for p in procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                # straggler/hung host: kill it and let the recovery
                # rounds below re-run its unfinished tiles
                logger.error(f'worker pid {p.pid} exceeded {timeout}s; '
                             'killing (tiles will be reassigned)')
                p.kill()
                p.wait()

    launch(jobs, n_hosts, 0)
    merged = merge_manifests(manifest_path, n_hosts)

    for round_idx in range(1, max_host_failures + 1):
        pending = [j for j in jobs
                   if merged.state.get(j.tile_id, {}).get('status')
                   != 'done']
        if not pending:
            break
        # survivors re-run the lost tiles (single worker is enough for
        # the recovery pass; tiles are independent)
        launch(pending, 1, round_idx)
        merged = merge_manifests(manifest_path, n_hosts)

    done = sum(1 for e in merged.state.values()
               if e.get('status') == 'done')
    failed = sum(1 for e in merged.state.values()
                 if e.get('status') == 'failed')
    return merged, {'tiles_done': done, 'tiles_failed': failed,
                    'tiles_total': len(jobs)}


if __name__ == '__main__':
    sys.exit(run_host_worker(sys.argv[1]))
