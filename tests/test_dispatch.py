"""Multi-host campaign dispatch: 2-process integration + shard/merge units.

The scale-out layer (SURVEY.md §2/§5 commitment): tiles are partitioned
across worker processes, each worker keeps a single-writer manifest
shard, and lost workers' tiles are recoverable by re-dispatch.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import synthetic  # noqa: E402

from proteus_jax.parallel.campaign import CampaignManifest, TileJob
from proteus_jax.parallel import dispatch


class TestUnits:
    def test_host_shard_round_robin(self):
        jobs = [TileJob(f't{i}', [], '/tmp') for i in range(7)]
        s0 = dispatch.host_shard(jobs, 0, 3)
        s1 = dispatch.host_shard(jobs, 1, 3)
        s2 = dispatch.host_shard(jobs, 2, 3)
        assert [j.tile_id for j in s0] == ['t0', 't3', 't6']
        assert [j.tile_id for j in s1] == ['t1', 't4']
        assert [j.tile_id for j in s2] == ['t2', 't5']
        # partition: disjoint and complete
        ids = [j.tile_id for s in (s0, s1, s2) for j in s]
        assert sorted(ids) == sorted(j.tile_id for j in jobs)

    def test_job_roundtrip(self):
        j = TileJob('tx', ['/a.tif'], '/out', dem_file='/dem.tif',
                    ocean_masking_shoreline_distance_km=2.5)
        back = dispatch.job_from_dict(dispatch.job_to_dict(j))
        for f in dispatch._JOB_FIELDS:
            assert getattr(back, f) == getattr(j, f)

    def test_merge_prefers_done(self, tmp_path):
        mp = str(tmp_path / 'manifest.json')
        a = CampaignManifest(dispatch.host_manifest_path(mp, 0))
        a.mark('t0', 'done')
        a.mark('t1', 'failed', error='io')
        b = CampaignManifest(dispatch.host_manifest_path(mp, 1))
        b.mark('t1', 'done')
        merged = dispatch.merge_manifests(mp, 2)
        assert merged.state['t0']['status'] == 'done'
        assert merged.state['t1']['status'] == 'done'


class TestWorkerEnvs:
    """On a GPU machine every worker process gets a card of its own."""

    def test_one_card_per_worker(self):
        envs = dispatch.worker_envs(2, platform='cuda', gpus=['0', '3'])
        assert envs == [{'CUDA_VISIBLE_DEVICES': '0'},
                        {'CUDA_VISIBLE_DEVICES': '3'}]

    def test_more_workers_than_cards_refused(self):
        with pytest.raises(ValueError, match='card of its own'):
            dispatch.worker_envs(3, platform='cuda', gpus=['0', '1'])

    def test_cpu_workers_share_the_backend(self):
        assert dispatch.worker_envs(3, platform='cpu',
                                    gpus=['0']) == [{}, {}, {}]

    def test_no_card_no_override(self):
        assert dispatch.worker_envs(2, platform='cuda', gpus=[]) == [{}, {}]

    def test_visible_gpus_honours_cuda_visible_devices(self, monkeypatch):
        monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '2, 5')
        assert dispatch.visible_gpus() == ['2', '5']
        envs = dispatch.worker_envs(2, platform='cuda')
        assert [e['CUDA_VISIBLE_DEVICES'] for e in envs] == ['2', '5']


@pytest.fixture(scope='module')
def tiny_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('dispatch_ds')
    files, _ = synthetic.make_hls_v2_dataset(str(root), size=120)
    return files


class TestTwoHostIntegration:
    def _jobs(self, files, out_root, n):
        return [TileJob(f'tile{i}', files,
                        os.path.join(out_root, f'tile{i}'))
                for i in range(n)]

    def test_dispatch_and_lost_host_recovery(self, tiny_dataset, tmp_path):
        out_root = str(tmp_path / 'out')
        mp = str(tmp_path / 'manifest.json')
        jobs = self._jobs(tiny_dataset, out_root, 4)
        merged, stats = dispatch.dispatch_campaign(
            jobs, n_hosts=2, manifest_path=mp,
            scratch_dir=str(tmp_path / 'scratch'), platform='cpu')
        assert stats == {'tiles_done': 4, 'tiles_failed': 0,
                         'tiles_total': 4}
        wtr = os.path.join(out_root, 'tile1',
                           'dswx_hls_v0.1_B01_WTR.tif')
        assert os.path.isfile(wtr)

        # simulate a lost host: its manifest shard and outputs vanish
        os.remove(dispatch.host_manifest_path(mp, 1))
        import shutil
        shutil.rmtree(os.path.join(out_root, 'tile1'))
        shutil.rmtree(os.path.join(out_root, 'tile3'))
        kept_mtime = os.path.getmtime(os.path.join(
            out_root, 'tile0', 'dswx_hls_v0.1_B01_WTR.tif'))

        merged, stats = dispatch.dispatch_campaign(
            jobs, n_hosts=2, manifest_path=mp,
            scratch_dir=str(tmp_path / 'scratch2'), platform='cpu')
        assert stats['tiles_done'] == 4 and stats['tiles_failed'] == 0
        assert os.path.isfile(wtr)  # lost tiles re-produced
        # the surviving host's finished tiles were skipped, not re-run
        assert os.path.getmtime(os.path.join(
            out_root, 'tile0', 'dswx_hls_v0.1_B01_WTR.tif')) == kept_mtime

    def test_hung_worker_is_killed_and_recovered(self, tiny_dataset,
                                                 tmp_path, monkeypatch):
        """A worker that exceeds the timeout is killed; its tiles are
        re-run by the in-process recovery round instead of crashing the
        dispatcher."""
        import subprocess

        real_popen = subprocess.Popen
        hung = {'count': 0}

        class _HungProc:
            pid = 99999

            def wait(self, timeout=None):
                if hung['count'] == 0:
                    hung['count'] = 1
                    raise subprocess.TimeoutExpired('worker', timeout)
                return 0

            def kill(self):
                return None

        def fake_popen(cmd, *a, **k):
            # first worker 'hangs'; the rest run for real
            if hung['count'] == 0 and cmd[-1].endswith('host0_r0.json'):
                return _HungProc()
            return real_popen(cmd, *a, **k)

        monkeypatch.setattr(dispatch.subprocess, 'Popen', fake_popen)
        out_root = str(tmp_path / 'out')
        jobs = self._jobs(tiny_dataset, out_root, 4)
        merged, stats = dispatch.dispatch_campaign(
            jobs, n_hosts=2, manifest_path=str(tmp_path / 'm.json'),
            scratch_dir=str(tmp_path / 'scratch'), platform='cpu')
        assert stats['tiles_done'] == 4 and stats['tiles_failed'] == 0
        assert hung['count'] == 1
