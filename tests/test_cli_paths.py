"""Coverage for the remaining CLI/orchestrator paths: raster-args mode,
debug windows, RGB composites, otsu shadow, VRT output, scaled inputs,
schema validation errors."""

import glob
import os

import numpy as np
import pytest

import oracle
import synthetic

from proteus_jax.cli.dswx_hls import main as dswx_hls_main
from proteus_jax.config import validator
from proteus_jax.core.thresholds import HlsThresholds
from proteus_jax.io.tiff import TiffReader

T = HlsThresholds()
TDICT = {k: getattr(T, k) for k in T.__dataclass_fields__}


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('clipaths')
    input_dir = str(root / 'input')
    files, bands = synthetic.make_hls_v2_dataset(input_dir, size=128)
    dem = synthetic.make_dem(str(root), size=128)
    lc = synthetic.make_landcover(str(root), size=128)
    wc = synthetic.make_worldcover(str(root), size=128)
    # the coverage check defaults to True (as in the reference), so the
    # raster-args CLI mode needs the ancillary files on every call
    anc = ['--dem', dem, '--landcover', lc, '--worldcover', wc]
    return root, files, bands, anc


def test_raster_args_single_layer(dataset, tmp_path):
    """CLI with raster files (no runconfig): only the requested layer is
    produced, collapsed, with a color table."""
    root, files, bands, anc = dataset
    out = str(tmp_path / 'wtr_only.tif')
    dswx_hls_main(files + anc + ['--wtr', out])
    assert os.path.isfile(out)
    with TiffReader(out) as r:
        wtr = r.read()
        assert r.count == 1
        assert r.color_map() is not None
    assert set(np.unique(wtr)) <= {0, 1, 2, 252, 253, 254, 255}


def test_debug_mode_window(dataset, tmp_path):
    root, files, _, anc = dataset
    out = str(tmp_path / 'dbg.tif')
    dswx_hls_main(files + anc + ['--wtr', out, '--debug'])
    with TiffReader(out) as r:
        # 128 < 1000: debug window clips to the full image
        assert (r.length, r.width) == (128, 128)


def test_rgb_outputs(dataset, tmp_path):
    root, files, bands, anc = dataset
    rgb = str(tmp_path / 'rgb.tif')
    irgb = str(tmp_path / 'irgb.tif')
    dswx_hls_main(files + anc + ['--wtr', str(tmp_path / 'w.tif'),
                           '--output-rgb', rgb,
                           '--output-infrared-rgb', irgb])
    with TiffReader(rgb) as r:
        arr = r.read()
        assert arr.shape == (128, 128, 3)
        assert arr.dtype == np.float32
        # scaled reflectance: red band / 1e4 with NaN at fill
        red = bands['B04']
        want = np.clip(red, 1, None).astype(np.float32) * 1e-4
        want[red == -9999] = np.nan
        np.testing.assert_allclose(arr[:, :, 0], want, rtol=1e-6)
    with TiffReader(irgb) as r:
        assert r.read().shape == (128, 128, 3)


def test_otsu_shadow_path(dataset, tmp_path):
    root, files, _, anc = dataset
    shad = str(tmp_path / 'shad.tif')
    dswx_hls_main(files + anc + ['--wtr', str(tmp_path / 'w.tif'),
                                 '--shad', shad,
                                 '--shadow-masking-algorithm', 'otsu'])
    with TiffReader(shad) as r:
        vals = set(np.unique(r.read()))
    assert vals <= {0, 1} and len(vals) == 2


def test_vrt_output(dataset, tmp_path):
    root, files, _, anc = dataset
    vrt = str(tmp_path / 'product.vrt')
    dswx_hls_main(files + anc + ['--wtr', str(tmp_path / 'w.tif'),
                           '--bwtr', str(tmp_path / 'b.tif'),
                           '-o', vrt])
    assert os.path.isfile(vrt)
    text = open(vrt).read()
    assert '<VRTDataset' in text and 'w.tif' in text and 'b.tif' in text


def test_scaled_inputs_mode(dataset, tmp_path):
    """--offset-and-scale-inputs runs the float path end-to-end."""
    root, files, bands, anc = dataset
    out = str(tmp_path / 'scaled_wtr.tif')
    dswx_hls_main(files + anc + ['--wtr', out,
                                 '--offset-and-scale-inputs'])
    with TiffReader(out) as r:
        wtr = r.read()
    assert set(np.unique(wtr)) <= {0, 1, 2, 252, 253, 254, 255}


def test_schema_validation_rejects_bad_runconfig(dataset, tmp_path):
    root, files, _, anc = dataset
    rc = str(tmp_path / 'bad.yaml')
    synthetic.write_runconfig(
        rc, os.path.dirname(files[0]), str(tmp_path), str(tmp_path),
        extra_processing={'shadow_masking_algorithm': 'bogus_algo'})
    with pytest.raises(validator.SchemaError):
        dswx_hls_main([rc])


def test_invalid_shadow_algorithm_raises(dataset, tmp_path):
    from proteus_jax.runtime.orchestrator import generate_dswx_layers
    root, files, _, anc = dataset
    with pytest.raises(ValueError):
        generate_dswx_layers(files,
                             output_interpreted_band=str(tmp_path
                                                         / 'w.tif'),
                             check_ancillary_inputs_coverage=False,
                             shadow_masking_algorithm='bogus_algo')


def test_stage_timers_logged(dataset, tmp_path, caplog):
    import logging
    root, files, _, anc = dataset
    with caplog.at_level(logging.INFO, logger='dswx_hls'):
        dswx_hls_main(files + anc + ['--wtr', str(tmp_path / 'w.tif')])
    text = '\n'.join(r.message for r in caplog.records)
    assert 'stage timing breakdown' in text
    assert 'device chain' in text


def test_validate_cog_cli(dataset, tmp_path, capsys):
    from proteus_jax.cli.validate_cog import main as vmain
    root, files, _, anc = dataset
    assert vmain([files[0]]) == 0
    bad = str(tmp_path / 'bad.tif')
    open(bad, 'wb').write(b'not a tiff at all')
    assert vmain([bad]) == 1


def test_full_log_format(tmp_path):
    import logging
    from proteus_jax.runtime.logging_util import create_logger
    logf = str(tmp_path / 'x.log')
    lg = create_logger(logf, full_log_formatting=True,
                       capture_std_streams=False)
    lg.info('hello world')
    for h in list(lg.handlers):
        h.flush()
        lg.removeHandler(h)
    text = open(logf).read()
    assert 'DSWx-HLS' in text and '999999' in text and 'hello world' in text


def test_stream_to_logger():
    import logging
    from proteus_jax.runtime.logging_util import StreamToLogger
    records = []

    class L:
        def log(self, level, msg):
            records.append(msg)
    s = StreamToLogger(L(), logging.INFO, prefix='[P] ')
    s.write('partial')
    s.write(' line\nsecond\n')
    s.flush()
    assert records == ['[P] partial line', '[P] second']


def test_multiband_output_file(dataset, tmp_path):
    """-o product.tif: combined 10-band uint8 product (all bands byte,
    collapsable layers collapsed, missing-layer planes filled)."""
    root, files, _, anc = dataset
    out = str(tmp_path / 'combined.tif')
    dswx_hls_main(files + anc + ['-o', out])
    with TiffReader(out) as r:
        arr = r.read()
        assert r.count == 10
        assert arr.dtype == np.uint8
        descs = r.band_descriptions()
    assert descs[0].startswith('Water classification')
    assert descs[9].startswith('Digital elevation model')
    # WTR band is collapsed
    assert set(np.unique(arr[:, :, 0])) <= {0, 1, 2, 252, 253, 254, 255}
