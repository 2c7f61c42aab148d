"""Campaign-mode tests on the virtual 8-device CPU mesh."""

import glob
import os

import numpy as np
import pytest

import jax

import oracle
import synthetic

from proteus_jax.core.thresholds import HlsThresholds
from proteus_jax.models.dswx.chain import DswxChainConfig
from proteus_jax.parallel.campaign import (CampaignRunner, TileJob,
                                           make_campaign_step)
from proteus_jax.parallel.mesh import make_tile_mesh
from proteus_jax.io.tiff import TiffReader

T = HlsThresholds()
TDICT = {k: getattr(T, k) for k in T.__dataclass_fields__}


def test_mesh_has_8_devices():
    mesh = make_tile_mesh()
    assert len(mesh.devices.flat) == 8


@pytest.mark.parametrize('mode', ['mask', 'cover'])
def test_campaign_step_matches_oracle(mode):
    mesh = make_tile_mesh()
    cfg = DswxChainConfig(apply_aerosol_class_remapping=False,
                          mask_adjacent_to_cloud_mode=mode)
    step = make_campaign_step(cfg, mesh)
    rng = np.random.default_rng(0)
    B, H, W = 8, 64, 64
    bands = [np.clip(rng.integers(-2000, 15000, (B, H, W)), 1,
                     None).astype(np.int16) for _ in range(6)]
    fmask = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    invalid = rng.random((B, H, W)) < 0.05
    out, totals = step(*bands, fmask, invalid)

    n_valid = 0
    for k in range(B):
        want = oracle.full_chain(*[b[k] for b in bands], fmask[k],
                                 invalid[k], TDICT, mode=mode)
        for layer in ('DIAG', 'WTR', 'CONF', 'CLOUD'):
            np.testing.assert_array_equal(np.asarray(out[layer][k]),
                                          want[layer],
                                          err_msg=f'tile {k} {layer}')
        n_valid += int((~invalid[k]).sum())
    assert int(totals['n_valid_total']) == n_valid
    assert int(totals['n_tiles_total']) == B


def _random_batch(rng, B, H, W, ancillaries=False):
    bands = [np.clip(rng.integers(-2000, 15000, (B, H, W)), 1,
                     None).astype(np.int16) for _ in range(6)]
    fmask = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    invalid = rng.random((B, H, W)) < 0.05
    extras = []
    if ancillaries:
        extras = [(rng.random((B, H, W)) < 0.9).astype(np.uint8),
                  (rng.random((B, H, W)) < 0.8).astype(np.uint8),
                  rng.choice(np.array([0, 100, 200, 201, 255], np.uint8),
                             (B, H, W))]
    return bands, fmask, invalid, extras


def _assert_tiles_match_chain(out, bands, fmask, invalid, extras, cfg,
                              layers, **chain_kw):
    from proteus_jax.models.dswx.chain import dswx_chain
    names = ('ocean_mask', 'shadow_layer', 'landcover_mask')
    for k in range(fmask.shape[0]):
        anc = {n: e[k] for n, e in zip(names, extras)}
        want = dswx_chain(*[b[k] for b in bands], fmask[k], invalid[k],
                          cfg, **anc, **chain_kw)
        for layer in layers:
            np.testing.assert_array_equal(
                np.asarray(out[layer][k]), np.asarray(want[layer]),
                err_msg=f'tile {k} {layer}')


ALL_LAYERS = ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF', 'CLOUD')


@pytest.mark.parametrize('mode', ['mask', 'cover'])
def test_campaign_step_all_ancillaries_matches_chain(mode):
    """The production dp step with every ancillary mask and two tiles
    per device (a real per-device batch): every layer bit-identical to
    the single-tile chain."""
    mesh = make_tile_mesh()
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
    step = make_campaign_step(cfg, mesh, with_ocean=True, with_shadow=True,
                              with_landcover=True)
    bands, fmask, invalid, extras = _random_batch(
        np.random.default_rng(5), 16, 64, 64, ancillaries=True)
    out, totals = step(*bands, fmask, invalid, *extras)
    _assert_tiles_match_chain(out, bands, fmask, invalid, extras, cfg,
                              ALL_LAYERS)
    # valid pixels exclude the ocean-masked ones
    assert int(totals['n_valid_total']) == int(
        (~invalid & (extras[0] != 0)).sum())
    assert int(totals['n_tiles_total']) == 16


class TestCampaignRunner:
    @pytest.fixture(scope='class')
    def jobs(self, tmp_path_factory):
        root = tmp_path_factory.mktemp('campaign')
        jobs = []
        tiles = {}
        for t in range(10):  # more tiles than devices: multiple batches
            input_dir = str(root / f'in_{t}')
            files, bands = synthetic.make_hls_v2_dataset(
                input_dir, size=96, seed=100 + t)
            jobs.append(TileJob(f'T{t:02}', files,
                                str(root / f'out_{t}'),
                                product_id=f'tile{t:02}'))
            tiles[f'T{t:02}'] = bands
        return root, jobs, tiles

    def test_runner_end_to_end(self, jobs):
        root, job_list, tiles = jobs
        manifest = str(root / 'manifest.json')
        runner = CampaignRunner(manifest_path=manifest)
        stats = runner.run(job_list)
        assert stats['tiles_done'] == 10
        assert stats['tiles_failed'] == 0
        # all tiles produced their 7 core layers
        for job in job_list:
            outs = glob.glob(os.path.join(job.output_dir, '*.tif'))
            assert len(outs) == 7, job.tile_id
        # spot-check one tile's WTR against the oracle
        bands = tiles['T03']
        invalid = np.zeros(bands['B02'].shape, bool)
        arrs = {}
        for key, name in [('blue', 'B02'), ('green', 'B03'),
                          ('red', 'B04'), ('nir', 'B8A'),
                          ('swir1', 'B11'), ('swir2', 'B12')]:
            invalid |= (bands[name] == -9999)
            arrs[key] = np.clip(bands[name], 1, None)
        lists = {0: [224, 160, 96], 2: [224, 160, 96],
                 3: [224, 192, 160, 128, 96],
                 4: [224, 192, 160, 128, 96]}
        want = oracle.full_chain(arrs['blue'], arrs['green'], arrs['red'],
                                 arrs['nir'], arrs['swir1'],
                                 arrs['swir2'], bands['Fmask'], invalid,
                                 TDICT, aerosol_lists=lists)
        with TiffReader(os.path.join(
                job_list[3].output_dir,
                'tile03_v0.1_B01_WTR.tif')) as r:
            got = r.read()
        np.testing.assert_array_equal(got, oracle.collapse(want['WTR']))

    def test_manifest_resume(self, jobs):
        root, job_list, _ = jobs
        manifest = str(root / 'manifest.json')
        runner = CampaignRunner(manifest_path=manifest)
        # all tiles already done -> nothing reprocessed
        stats = runner.run(job_list)
        assert stats['tiles_done'] == 0
        assert stats['tiles_failed'] == 0

    def test_failure_detection_and_retry(self, jobs, tmp_path):
        root, _, _ = jobs
        bad = TileJob('BAD', ['/nonexistent/B02.tif'], str(tmp_path))
        runner = CampaignRunner(manifest_path=str(tmp_path /
                                                  'manifest.json'),
                                max_retries=1)
        stats = runner.run([bad])
        assert stats['tiles_failed'] == 1
        assert runner.manifest.status('BAD') == 'failed'


class TestSpatialSharding:
    """2-D (tile, space) mesh with halo exchange must be bit-identical to
    single-device execution, including the 'cover'-mode dilations that
    cross shard boundaries."""

    @pytest.mark.parametrize('mode', ['mask', 'cover'])
    def test_spatial_matches_single_device(self, mode):
        from proteus_jax.parallel.campaign import make_spatial_campaign_step
        from proteus_jax.parallel.mesh import make_tile_space_mesh
        from proteus_jax.models.dswx.chain import dswx_chain

        mesh = make_tile_space_mesh(2, 4)
        cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
        step = make_spatial_campaign_step(cfg, mesh)

        rng = np.random.default_rng(2)
        B, H, W = 2, 128, 64
        bands = [np.clip(rng.integers(-2000, 15000, (B, H, W)), 1,
                         None).astype(np.int16) for _ in range(6)]
        fmask = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
        invalid = rng.random((B, H, W)) < 0.05
        out, totals = step(*bands, fmask, invalid)

        for k in range(B):
            want = dswx_chain(*[b[k] for b in bands], fmask[k],
                              invalid[k], cfg)
            for layer in ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR',
                          'CONF', 'CLOUD'):
                np.testing.assert_array_equal(
                    np.asarray(out[layer][k]), np.asarray(want[layer]),
                    err_msg=f'tile {k} {layer} mode {mode}')
        assert int(totals['n_valid_total']) == int((~invalid).sum())

    @pytest.mark.parametrize('mode', ['mask', 'cover'])
    def test_spatial_ancillaries_matches_single_device(self, mode):
        """dp x sp sharding with every ancillary mask: the masks are
        halo-exchanged with their nodata-neutral edge fills and the
        result is bit-identical to the single-device chain."""
        from proteus_jax.parallel.campaign import make_spatial_campaign_step
        from proteus_jax.parallel.mesh import make_tile_space_mesh

        mesh = make_tile_space_mesh(2, 4)
        cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
        step = make_spatial_campaign_step(cfg, mesh, with_ocean=True,
                                          with_shadow=True,
                                          with_landcover=True)
        bands, fmask, invalid, extras = _random_batch(
            np.random.default_rng(3), 2, 128, 64, ancillaries=True)
        out, totals = step(*bands, fmask, invalid, *extras)
        _assert_tiles_match_chain(out, bands, fmask, invalid, extras, cfg,
                                  ALL_LAYERS)
        assert int(totals['n_valid_total']) == int((~invalid).sum())


def test_spatial_step_scaled_device_scale_matches_chain():
    """dp x sp sharding in scaled mode with the device-side cast: must
    match the single-device float chain on the host-cast bands
    bit-for-bit (per-tile scale/offset vectors replicated across the
    space shards; cast runs before the halo exchange)."""
    from proteus_jax.models.dswx.chain import dswx_chain
    from proteus_jax.parallel.campaign import make_spatial_campaign_step
    from proteus_jax.parallel.mesh import make_tile_space_mesh

    mesh = make_tile_space_mesh(2, 4)
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode='cover')
    step = make_spatial_campaign_step(cfg, mesh, float_inputs=True,
                                      device_scale=True)
    rng = np.random.default_rng(11)
    B, H, W = 2, 128, 64
    raw = [rng.integers(-2000, 15000, (B, H, W)).astype(np.int16)
           for _ in range(6)]
    scales = (np.float32(0.0001)
              * rng.uniform(0.5, 2.0, (B, 6))).astype(np.float32)
    offsets = rng.choice(
        np.asarray([0.0, -0.1, 0.25], np.float32), (B, 6))
    fmask = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    invalid = rng.random((B, H, W)) < 0.05
    out, totals = step(*raw, fmask, invalid, scales, offsets)
    cast = [scales[:, j, None, None]
            * (raw[j].astype(np.float32) - offsets[:, j, None, None])
            for j in range(6)]
    for k in range(B):
        want = dswx_chain(*[c[k] for c in cast], fmask[k], invalid[k],
                          cfg)
        for layer in ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF',
                      'CLOUD'):
            np.testing.assert_array_equal(
                np.asarray(out[layer][k]), np.asarray(want[layer]),
                err_msg=f'tile {k} {layer}')
    assert int(totals['n_valid_total']) == int((~invalid).sum())


@pytest.mark.parametrize('mode', ['mask', 'cover'])
def test_spatial_step_float_inputs_matches_chain(mode):
    """dp x sp sharding of the scaled-reflectance (float32) chain on
    host-cast bands: float bands cross the halo exchange and the result
    matches the single-device float chain bit-for-bit."""
    from proteus_jax.parallel.campaign import make_spatial_campaign_step
    from proteus_jax.parallel.mesh import make_tile_space_mesh

    mesh = make_tile_space_mesh(2, 4)
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
    step = make_spatial_campaign_step(cfg, mesh, float_inputs=True)
    raw, fmask, invalid, _ = _random_batch(np.random.default_rng(13),
                                           2, 128, 64)
    bands = [np.float32(0.0001) * b.astype(np.float32) for b in raw]
    out, totals = step(*bands, fmask, invalid)
    _assert_tiles_match_chain(out, bands, fmask, invalid, [], cfg,
                              ALL_LAYERS)
    assert int(totals['n_valid_total']) == int((~invalid).sum())


def test_campaign_runner_spatial_scaled(tmp_path):
    """Spatial-sharded scaled campaign through the runner: products
    byte-identical to the data-parallel scaled campaign."""
    d = str(tmp_path / 'in')
    files, _bands = synthetic.make_hls_v2_dataset(d, size=96, seed=777)
    outs = {}
    for tag, spatial in (('dp', 1), ('sp', 4)):
        out = str(tmp_path / f'camp_{tag}')
        runner = CampaignRunner(config=DswxChainConfig(),
                                scaled_inputs=True, device_scale=True,
                                spatial_shards=spatial)
        stats = runner.run([TileJob('S0', files, out, product_id='sc')])
        assert stats['tiles_failed'] == 0
        outs[tag] = out
    dp_tifs = sorted(glob.glob(os.path.join(outs['dp'], '*.tif')))
    assert dp_tifs
    for hf in dp_tifs:
        sf = os.path.join(outs['sp'], os.path.basename(hf))
        with TiffReader(hf) as ra, TiffReader(sf) as rb:
            np.testing.assert_array_equal(
                ra.read(), rb.read(), err_msg=os.path.basename(hf))


def test_campaign_cli(tmp_path):
    """Drive the dswx_campaign CLI end-to-end on two synthetic tiles."""
    from proteus_jax.cli.dswx_campaign import main as campaign_main
    dirs = []
    for t in range(2):
        d = str(tmp_path / f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=96, seed=300 + t)
        dirs.append(d)
    out = str(tmp_path / 'campaign_out')
    campaign_main(dirs + ['-o', out])
    for t in range(2):
        produced = glob.glob(os.path.join(out, f'tile_{t}', '*.tif'))
        assert len(produced) == 7
    assert os.path.isfile(os.path.join(out, 'campaign_manifest.json'))


def test_campaign_otsu_shadow_algorithm(tmp_path):
    """The campaign reader honors shadow_masking_algorithm='otsu': its
    SHAD equals the exact otsu chain over the same warped (margined)
    DEM and differs from the default algorithm's; the cache keys the
    two algorithms separately."""
    from proteus_jax.core import constants as C
    from proteus_jax.geo.warp import warp_to_grid_device
    from proteus_jax.models.dswx.shadow import (
        compute_otsu_shadow_layer_exact)
    from proteus_jax.parallel import campaign as camp
    camp.ANCILLARY_CACHE.clear()
    d = str(tmp_path / 'in')
    files, _ = synthetic.make_hls_v2_dataset(d, size=96)
    dem = synthetic.make_dem(str(tmp_path), size=96)
    job = TileJob('c0', files, str(tmp_path / 'o'), dem_file=dem)

    d_otsu = camp._read_tile(job, config=DswxChainConfig(
        shadow_masking_algorithm='otsu'))
    d_def = camp._read_tile(job, config=DswxChainConfig())
    got = np.asarray(d_otsu['shadow_layer'])
    default = np.asarray(d_def['shadow_layer'])
    assert (got != default).any()

    from proteus_jax.runtime.orchestrator import _mean_angle
    gt = d_otsu['geotransform']
    proj = d_otsu['projection']
    length, width = d_otsu['length'], d_otsu['width']
    md = d_otsu['hls_metadata']
    az = _mean_angle(md.get('MEAN_SUN_AZIMUTH_ANGLE', '0'))
    zen = _mean_angle(md.get('MEAN_SUN_ZENITH_ANGLE', '0'))
    m = C.DEM_MARGIN_IN_PIXELS
    dem_m = warp_to_grid_device(dem, gt, proj, length, width,
                                resample_algorithm='cubic',
                                margin_in_pixels=m)
    want = np.asarray(compute_otsu_shadow_layer_exact(
        dem_m, az, 90.0 - zen, pixel_spacing_x=gt[1],
        pixel_spacing_y=gt[5], as_device=True))[m:-m, m:-m]
    np.testing.assert_array_equal(got.astype(bool), want)
    camp.ANCILLARY_CACHE.clear()


def test_campaign_cli_dispatch_forwards_scaled(tmp_path, monkeypatch):
    """Regression: the --hosts>1 dispatch branch must forward --scaled
    into every worker's runner_kwargs (it used to drop it, silently
    running the integer chain on worker hosts)."""
    from proteus_jax.cli import dswx_campaign
    from proteus_jax.parallel import dispatch
    d = str(tmp_path / 'tile_0')
    synthetic.make_hls_v2_dataset(d, size=96, seed=42)
    seen = {}

    def fake_dispatch(jobs, **kw):
        seen.update(kw)
        return {}, {'tiles_done': len(jobs), 'tiles_failed': 0}

    monkeypatch.setattr(dispatch, 'dispatch_campaign', fake_dispatch)
    out = str(tmp_path / 'o')
    with pytest.raises(SystemExit) as ex:
        dswx_campaign.main([d, '-o', out, '--hosts', '2', '--scaled'])
    assert ex.value.code == 0
    assert seen['runner_kwargs']['scaled_inputs'] is True


def test_tiles_per_device_default():
    """The runner defaults to one tile per device per batch on every
    backend; an explicit value wins and sets the batch size."""
    from proteus_jax.parallel import campaign as cmod
    mesh = make_tile_mesh()
    r = cmod.CampaignRunner(mesh=mesh)
    assert r.tiles_per_device == 1
    assert r.batch_size == mesh.shape[cmod.TILE_AXIS]
    r3 = cmod.CampaignRunner(mesh=mesh, tiles_per_device=3)
    assert r3.tiles_per_device == 3
    assert r3.batch_size == 3 * mesh.shape[cmod.TILE_AXIS]


def test_campaign_tiles_per_device(tmp_path):
    """tiles_per_device > 1: each device's local step loops over several
    tiles per dispatch; products identical to the per-tile path."""
    from proteus_jax.models.dswx.chain import DswxChainConfig
    from proteus_jax.parallel.campaign import CampaignRunner, TileJob
    dirs = []
    for t in range(4):
        d = str(tmp_path / f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=96, seed=700 + t)
        dirs.append(d)

    def run(tag, **kw):
        out = str(tmp_path / tag)
        jobs = [TileJob(f'tile_{t}',
                        sorted(glob.glob(os.path.join(dirs[t], '*.tif'))),
                        os.path.join(out, f'tile_{t}'))
                for t in range(4)]
        r = CampaignRunner(config=DswxChainConfig(), **kw)
        stats = r.run(jobs)
        assert stats['tiles_failed'] == 0
        return out

    a = run('per_tile')
    b = run('batched', tiles_per_device=2)
    from proteus_jax.io.tiff import TiffReader
    for t in range(4):
        for f in sorted(glob.glob(os.path.join(a, f'tile_{t}',
                                               '*.tif'))):
            other = os.path.join(b, f'tile_{t}', os.path.basename(f))
            np.testing.assert_array_equal(TiffReader(f).read(),
                                          TiffReader(other).read(),
                                          err_msg=f)


def test_campaign_cli_multihost(tmp_path, monkeypatch):
    """--hosts 2 routes through the multi-host dispatcher (per-host
    manifest shards, subprocess workers)."""
    import pytest
    monkeypatch.setenv('JAX_PLATFORMS', 'cpu')
    from proteus_jax.cli.dswx_campaign import main as campaign_main
    dirs = []
    for t in range(2):
        d = str(tmp_path / f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=96, seed=900 + t)
        dirs.append(d)
    out = str(tmp_path / 'mh_out')
    with pytest.raises(SystemExit) as exc:
        campaign_main(dirs + ['-o', out, '--hosts', '2'])
    assert exc.value.code == 0
    for t in range(2):
        assert len(glob.glob(os.path.join(out, f'tile_{t}',
                                          '*.tif'))) == 7
    assert os.path.isfile(os.path.join(
        out, 'campaign_manifest.host0.json'))


def test_campaign_full_product_with_ancillaries(tmp_path):
    """Campaign runner with DEM/landcover/ocean ancillaries + browse:
    all 10 layers and browse per tile, metadata from the tile's HLS
    attributes."""
    from proteus_jax.cli.dswx_campaign import main as campaign_main
    root = tmp_path
    dirs = []
    for t in range(3):
        d = str(root / f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=96, seed=500 + t)
        dirs.append(d)
    dem = synthetic.make_dem(str(root), size=96)
    lc = synthetic.make_landcover(str(root), size=96)
    wc = synthetic.make_worldcover(str(root), size=96)
    shore = synthetic.make_shoreline(str(root), size=96)
    out = str(root / 'out')
    campaign_main(dirs + ['-o', out, '--dem', dem, '--landcover', lc,
                          '--worldcover', wc, '--shoreline', shore,
                          '--browse',
                          '--ocean-masking-distance-km', '0.3'])
    for t in range(3):
        tdir = os.path.join(out, f'tile_{t}')
        tifs = sorted(os.path.basename(f)
                      for f in glob.glob(os.path.join(tdir, '*.tif')))
        layers = {n.split('_')[-1].replace('.tif', '') for n in tifs}
        assert layers >= {'WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1',
                          'WTR-2', 'LAND', 'SHAD', 'CLOUD', 'DEM',
                          'BROWSE'}, layers
        assert glob.glob(os.path.join(tdir, '*_BROWSE.png'))
        with TiffReader(glob.glob(os.path.join(tdir, '*_B01_WTR.tif'))[0]) \
                as r:
            md = r.metadata()
            wtr = r.read()
        assert md['SPACECRAFT_NAME'] == 'Sentinel-2A'
        assert md['SENSOR'] == 'MSI'
        # ocean masked on the east side (excluding the fill wedge and
        # the 0.3 km shoreline margin)
        east = wtr[:60, -5:]
        assert (east == 254).mean() > 0.9, east


def test_campaign_runner_scaled_inputs(tmp_path):
    """Scaled-reflectance campaign (float32 science chain): products
    must match the orchestrator's scaled mode on the same granule."""
    from proteus_jax.runtime.orchestrator import generate_dswx_layers
    d = str(tmp_path / 'in')
    files, _bands = synthetic.make_hls_v2_dataset(d, size=96, seed=321)
    out = str(tmp_path / 'camp')
    jobs = [TileJob('S0', files, out, product_id='sc')]
    runner = CampaignRunner(config=DswxChainConfig(),
                            scaled_inputs=True)
    stats = runner.run(jobs)
    assert stats['tiles_failed'] == 0
    ref_out = str(tmp_path / 'orch_wtr.tif')
    ok = generate_dswx_layers(files, output_interpreted_band=ref_out,
                              flag_offset_and_scale_inputs=True,
                              check_ancillary_inputs_coverage=False,
                              apply_ocean_masking=False)
    assert ok
    got_f = glob.glob(os.path.join(out, '*_B01_WTR.tif'))[0]
    with TiffReader(got_f) as rg, TiffReader(ref_out) as rr:
        np.testing.assert_array_equal(rg.read(), rr.read())


@pytest.mark.parametrize('with_ancillaries', [False, True])
def test_campaign_step_device_scale_matches_host_cast(with_ancillaries):
    """device_scale=True (raw int16 bands + on-device
    scale*(f32(band)-offset)) must be bit-identical to feeding the
    host-cast float32 bands through the same float-input step, with and
    without the ancillary masks."""
    mesh = make_tile_mesh()
    cfg = DswxChainConfig()
    kw = dict(float_inputs=True, with_ocean=with_ancillaries,
              with_shadow=with_ancillaries, with_landcover=with_ancillaries)
    step_dev = make_campaign_step(cfg, mesh, device_scale=True, **kw)
    step_host = make_campaign_step(cfg, mesh, **kw)
    rng = np.random.default_rng(77)
    # B = 2 x mesh size: each device holds TWO tiles, covering the
    # per-local-batch [local_B, 6] scale/offset indexing
    B, H, W = 16, 64, 64
    raw = [rng.integers(-2000, 15000, (B, H, W)).astype(np.int16)
           for _ in range(6)]
    # per-tile, per-band scale/offset (HLS granules carry per-band
    # values; exercise non-default offsets too)
    scales = (np.float32(0.0001)
              * rng.uniform(0.5, 2.0, (B, 6))).astype(np.float32)
    offsets = rng.choice(
        np.asarray([0.0, -0.1, 0.25], np.float32), (B, 6))
    fmask = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    invalid = rng.random((B, H, W)) < 0.05
    extras = _random_batch(rng, B, H, W, ancillaries=True)[3] \
        if with_ancillaries else []
    out_dev, tot_dev = step_dev(*raw, fmask, invalid, scales, offsets,
                                *extras)
    cast = [scales[:, j, None, None]
            * (raw[j].astype(np.float32) - offsets[:, j, None, None])
            for j in range(6)]
    out_host, tot_host = step_host(*cast, fmask, invalid, *extras)
    assert set(out_dev) == set(out_host)
    for k in out_dev:
        np.testing.assert_array_equal(np.asarray(out_dev[k]),
                                      np.asarray(out_host[k]),
                                      err_msg=k)
    assert int(tot_dev['n_valid_total']) == int(tot_host['n_valid_total'])


def test_campaign_runner_device_scale(tmp_path):
    """End-to-end: the device-scale campaign writes byte-identical
    products to the host-scaled campaign on the same granule."""
    d = str(tmp_path / 'in')
    files, _bands = synthetic.make_hls_v2_dataset(d, size=96, seed=654)
    outs = {}
    for tag, dev in (('host', False), ('dev', True)):
        out = str(tmp_path / f'camp_{tag}')
        runner = CampaignRunner(config=DswxChainConfig(),
                                scaled_inputs=True, device_scale=dev)
        assert runner.device_scale is dev
        stats = runner.run([TileJob('S0', files, out, product_id='sc')])
        assert stats['tiles_failed'] == 0
        outs[tag] = out
    host_tifs = sorted(glob.glob(os.path.join(outs['host'], '*.tif')))
    assert host_tifs
    for hf in host_tifs:
        df = os.path.join(outs['dev'], os.path.basename(hf))
        with TiffReader(hf) as rh, TiffReader(df) as rd:
            np.testing.assert_array_equal(
                rh.read(), rd.read(),
                err_msg=os.path.basename(hf))


def test_campaign_step_float_inputs_matches_chain():
    """The scaled-reflectance (float32) dp step on host-cast bands
    matches the single-tile float chain bit-for-bit."""
    mesh = make_tile_mesh()
    cfg = DswxChainConfig()
    step = make_campaign_step(cfg, mesh, float_inputs=True)
    raw, fmask, invalid, _ = _random_batch(np.random.default_rng(9),
                                           8, 64, 64)
    bands = [np.float32(0.0001) * b.astype(np.float32) for b in raw]
    out, totals = step(*bands, fmask, invalid)
    _assert_tiles_match_chain(out, bands, fmask, invalid, [], cfg,
                              ALL_LAYERS)
    assert int(totals['n_valid_total']) == int((~invalid).sum())


class TestAncillaryCache:
    def test_single_flight(self):
        import threading
        from proteus_jax.parallel.campaign import _AncillaryCache
        cache = _AncillaryCache(max_entries=4)
        calls = []
        barrier = threading.Barrier(4)

        def compute():
            calls.append(1)
            import time
            time.sleep(0.05)
            return object()

        results = []

        def worker():
            barrier.wait()
            results.append(cache.get('k', compute))

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(calls) == 1
        assert all(r is results[0] for r in results)

    def test_lru_and_error_eviction(self):
        from proteus_jax.parallel.campaign import _AncillaryCache
        cache = _AncillaryCache(max_entries=2)
        a = cache.get('a', lambda: 'va')
        assert cache.get('a', lambda: 'NEW') == 'va'
        cache.get('b', lambda: 'vb')
        cache.get('c', lambda: 'vc')  # evicts 'a'
        assert cache.get('a', lambda: 'va2') == 'va2'
        with pytest.raises(RuntimeError):
            cache.get('err', lambda: (_ for _ in ()).throw(
                RuntimeError('x')))
        # a failed computation is not cached
        assert cache.get('err', lambda: 'ok') == 'ok'
        del a

    def test_disabled_via_env(self, monkeypatch):
        from proteus_jax.parallel.campaign import _AncillaryCache
        monkeypatch.setenv('PROTEUS_ANC_CACHE', '0')
        cache = _AncillaryCache()
        calls = []
        cache.get('k', lambda: calls.append(1))
        cache.get('k', lambda: calls.append(1))
        assert len(calls) == 2

    def test_read_tile_reuses_dem_warp(self, tmp_path, monkeypatch):
        """Two jobs on the same grid share one DEM/landcover warp; the
        shadow key includes the sun angles."""
        from proteus_jax.parallel import campaign as camp
        import proteus_jax.geo.warp as warp_mod
        camp.ANCILLARY_CACHE.clear()
        d = str(tmp_path / 'in')
        files, _ = synthetic.make_hls_v2_dataset(d, size=96)
        dem = synthetic.make_dem(str(tmp_path), size=96)
        lc = synthetic.make_landcover(str(tmp_path), size=96)
        wc = synthetic.make_worldcover(str(tmp_path), size=96)
        calls = {'warp': 0}
        orig = warp_mod.warp_to_grid_device

        def counting(*a, **kw):
            calls['warp'] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(warp_mod, 'warp_to_grid_device', counting)
        job = TileJob('c0', files, str(tmp_path / 'o'), dem_file=dem,
                      landcover_file=lc, worldcover_file=wc)
        d1 = camp._read_tile(job, config=DswxChainConfig())
        n_first = calls['warp']
        assert n_first == 3  # dem + cgls + worldcover
        d2 = camp._read_tile(job, config=DswxChainConfig())
        assert calls['warp'] == n_first  # all cache hits
        assert d2['dem'] is d1['dem']
        assert d2['landcover_mask'] is d1['landcover_mask']
        assert d2['shadow_layer'] is d1['shadow_layer']
        camp.ANCILLARY_CACHE.clear()


def test_campaign_runner_spatial_shards(tmp_path):
    """CampaignRunner with a 2-D (tile x space) mesh produces the same
    products as the data-parallel runner, ancillaries included."""
    import oracle as _oracle
    dirs = []
    for t in range(2):
        d = str(tmp_path / f's_{t}')
        synthetic.make_hls_v2_dataset(d, size=96, seed=700 + t)
        dirs.append(d)
    shore = synthetic.make_shoreline(str(tmp_path), size=96)

    def run(spatial, outdir):
        jobs = [TileJob(f'S{t}', sorted(glob.glob(f'{d}/*.tif')),
                        os.path.join(outdir, f'S{t}'),
                        product_id=f'sp{t}',
                        shoreline_shapefile=shore,
                        ocean_masking_shoreline_distance_km=0.3)
                for t, d in enumerate(dirs)]
        runner = CampaignRunner(
            manifest_path=os.path.join(outdir, 'm.json'),
            spatial_shards=spatial,
            config=DswxChainConfig(mask_adjacent_to_cloud_mode='cover'))
        stats = runner.run(jobs)
        assert stats['tiles_failed'] == 0
        return outdir

    out_dp = run(1, str(tmp_path / 'dp'))
    out_sp = run(4, str(tmp_path / 'sp'))
    for t in range(2):
        for layer in ('B01_WTR', 'B09_CLOUD', 'B03_CONF'):
            a = glob.glob(os.path.join(out_dp, f'S{t}',
                                       f'*_{layer}.tif'))[0]
            b = glob.glob(os.path.join(out_sp, f'S{t}',
                                       f'*_{layer}.tif'))[0]
            with TiffReader(a) as ra, TiffReader(b) as rb:
                np.testing.assert_array_equal(ra.read(), rb.read(),
                                              err_msg=f'{t} {layer}')


class TestPrepOverlap:
    """The within-tile ancillary preps run concurrently (round 5): a
    cold tile pays max(ocean, dem+shadow, landcover), not their sum."""

    def test_run_preps_concurrent_and_ordered(self):
        import threading
        from proteus_jax.parallel.campaign import _run_preps
        barrier = threading.Barrier(2, timeout=10)

        def a():
            barrier.wait()   # deadlocks unless b runs concurrently
            return {'a': 1}

        def b():
            barrier.wait()
            return {'b': 2}

        assert _run_preps([a, b]) == [{'a': 1}, {'b': 2}]

    def test_run_preps_serial_when_disabled(self, monkeypatch):
        from proteus_jax.parallel.campaign import _run_preps
        monkeypatch.setenv('PROTEUS_PREP_THREADS', '0')
        order = []

        def mk(name):
            def fn():
                order.append(name)
                return {name: True}
            return fn

        out = _run_preps([mk('x'), mk('y'), mk('z')])
        assert order == ['x', 'y', 'z']
        assert out == [{'x': True}, {'y': True}, {'z': True}]

    def test_pool_prep_exception_propagates(self):
        from proteus_jax.parallel.campaign import _run_preps

        def ok():
            return {}

        def boom():
            raise IOError('bad ancillary')

        with pytest.raises(IOError, match='bad ancillary'):
            _run_preps([ok, boom])

    def test_read_tile_bad_dem_raises(self, tmp_path):
        """A broken ancillary in a pool-run prep surfaces as the same
        exception the serial code raised (the campaign retry path
        depends on it)."""
        from proteus_jax.parallel import campaign as camp
        camp.ANCILLARY_CACHE.clear()
        d = str(tmp_path / 'in')
        files, _ = synthetic.make_hls_v2_dataset(d, size=96)
        job = TileJob('bad', files, str(tmp_path / 'o'),
                      dem_file=str(tmp_path / 'missing_dem.tif'))
        with pytest.raises(Exception):
            camp._read_tile(job, config=DswxChainConfig())
        camp.ANCILLARY_CACHE.clear()


def test_campaign_step_browse_matches_chain():
    """compute_browse with non-default browse colours (not-water,
    cloud and snow as nodata): the batched step's BROWSE layer matches
    the single-tile chain."""
    mesh = make_tile_mesh()
    cfg = DswxChainConfig(not_water_in_browse='nodata',
                          cloud_in_browse='nodata', snow_in_browse='nodata',
                          exclude_psw_aggressive_in_browse=True)
    step = make_campaign_step(cfg, mesh, compute_browse=True)
    bands, fmask, invalid, _ = _random_batch(np.random.default_rng(21),
                                             8, 64, 64)
    out, _totals = step(*bands, fmask, invalid)
    _assert_tiles_match_chain(out, bands, fmask, invalid, [], cfg,
                              ALL_LAYERS + ('BROWSE',),
                              compute_browse=True)
