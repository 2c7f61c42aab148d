"""End-to-end workflow tests: CLI -> products, golden-compared against the
NumPy oracle (our network-free analogue of the reference Zenodo test)."""

import glob
import os

import numpy as np
import pytest

import oracle
import synthetic

from proteus_jax.cli.dswx_hls import main as dswx_hls_main
from proteus_jax.cli.dswx_compare import main as dswx_compare_main
from proteus_jax.core.thresholds import HlsThresholds
from proteus_jax.io.tiff import TiffReader
from proteus_jax.io.validate_cog import validate_cog
from proteus_jax.runtime.compare import compare_dswx_hls_products

T = HlsThresholds()
TDICT = {k: getattr(T, k) for k in T.__dataclass_fields__}

AEROSOL_LISTS = {0: [224, 160, 96], 2: [224, 160, 96],
                 3: [224, 192, 160, 128, 96],
                 4: [224, 192, 160, 128, 96]}


def _expected_layers(bands):
    """Golden layers from the float64 oracle, reproducing ingest
    semantics (clip negatives; cumulative invalid mask)."""
    invalid = np.zeros(bands['B02'].shape, bool)
    arrs = {}
    for key, name in [('blue', 'B02'), ('green', 'B03'), ('red', 'B04'),
                      ('nir', 'B8A'), ('swir1', 'B11'), ('swir2', 'B12')]:
        arr = bands[name]
        invalid |= (arr == -9999)
        arrs[key] = np.clip(arr, 1, None)
    fmask = bands['Fmask']
    return oracle.full_chain(arrs['blue'], arrs['green'], arrs['red'],
                             arrs['nir'], arrs['swir1'], arrs['swir2'],
                             fmask, invalid, TDICT, mode='mask',
                             aerosol_lists=AEROSOL_LISTS), invalid


@pytest.fixture(scope='module')
def workflow_outputs(tmp_path_factory):
    root = tmp_path_factory.mktemp('wf')
    input_dir = str(root / 'input')
    output_dir = str(root / 'output')
    scratch_dir = str(root / 'scratch')
    files, bands = synthetic.make_hls_v2_dataset(input_dir, size=360)
    rc = synthetic.write_runconfig(
        str(root / 'rc.yaml'), input_dir, output_dir, scratch_dir,
        check_coverage=False, apply_ocean_masking=False,
        extra_processing={'save_dem': 'False', 'save_shad': 'False',
                          'save_land': 'False'})
    dswx_hls_main([rc])
    return root, output_dir, bands


class TestWorkflowMinimal:
    """Config 1/3: HLS tile -> full product set, no ancillaries."""

    def test_outputs_exist(self, workflow_outputs):
        _, output_dir, _ = workflow_outputs
        produced = sorted(os.path.basename(f) for f in
                          glob.glob(os.path.join(output_dir, '*')))
        for expect in ['dswx_hls_test_v0.1_B01_WTR.tif',
                       'dswx_hls_test_v0.1_B02_BWTR.tif',
                       'dswx_hls_test_v0.1_B03_CONF.tif',
                       'dswx_hls_test_v0.1_B04_DIAG.tif',
                       'dswx_hls_test_v0.1_B05_WTR-1.tif',
                       'dswx_hls_test_v0.1_B06_WTR-2.tif',
                       'dswx_hls_test_v0.1_B09_CLOUD.tif',
                       'dswx_hls_test_v0.1_BROWSE.png',
                       'dswx_hls_test_v0.1_BROWSE.tif']:
            assert expect in produced, f'{expect} missing from {produced}'

    def test_layers_match_oracle(self, workflow_outputs):
        _, output_dir, bands = workflow_outputs
        want, invalid = _expected_layers(bands)
        layer_files = {'WTR': 'B01_WTR', 'BWTR': 'B02_BWTR',
                       'CONF': 'B03_CONF', 'DIAG': 'B04_DIAG',
                       'WTR-1': 'B05_WTR-1', 'WTR-2': 'B06_WTR-2',
                       'CLOUD': 'B09_CLOUD'}
        for layer, tag in layer_files.items():
            path = os.path.join(output_dir,
                                f'dswx_hls_test_v0.1_{tag}.tif')
            with TiffReader(path) as r:
                got = r.read()
            expected = want[layer]
            if layer in ('WTR', 'WTR-1', 'WTR-2'):
                expected = oracle.collapse(expected)
            np.testing.assert_array_equal(got, expected, err_msg=layer)

    def test_products_are_valid_cogs(self, workflow_outputs):
        _, output_dir, _ = workflow_outputs
        for path in glob.glob(os.path.join(output_dir, '*.tif')):
            assert validate_cog(path) == [], path

    def test_metadata(self, workflow_outputs):
        _, output_dir, _ = workflow_outputs
        path = os.path.join(output_dir, 'dswx_hls_test_v0.1_B01_WTR.tif')
        with TiffReader(path) as r:
            md = r.metadata()
        assert md['PRODUCT_ID'] == 'dswx_hls_test'
        assert md['PRODUCT_TYPE'] == 'DSWx-HLS'
        assert md['SPACECRAFT_NAME'] == 'Sentinel-2A'
        assert md['SENSOR'] == 'MSI'
        assert 'SPATIAL_COVERAGE' in md
        assert 'CLOUD_COVERAGE' in md
        assert md['AEROSOL_CLASS_REMAPPING_ENABLED'] == 'TRUE'

    def test_compare_self(self, workflow_outputs, capsys):
        _, output_dir, _ = workflow_outputs
        path = os.path.join(output_dir, 'dswx_hls_test_v0.1_B01_WTR.tif')
        assert compare_dswx_hls_products(path, path)

    def test_compare_detects_difference(self, workflow_outputs, tmp_path):
        _, output_dir, _ = workflow_outputs
        path = os.path.join(output_dir, 'dswx_hls_test_v0.1_B01_WTR.tif')
        other = os.path.join(output_dir, 'dswx_hls_test_v0.1_B02_BWTR.tif')
        assert not compare_dswx_hls_products(path, other)

    def test_compare_cli(self, workflow_outputs):
        _, output_dir, _ = workflow_outputs
        path = os.path.join(output_dir, 'dswx_hls_test_v0.1_B01_WTR.tif')
        assert dswx_compare_main([path, path])

    def test_browse_png(self, workflow_outputs):
        from PIL import Image
        _, output_dir, _ = workflow_outputs
        png = os.path.join(output_dir, 'dswx_hls_test_v0.1_BROWSE.png')
        im = Image.open(png)
        assert im.size == (1024, 1024)


class TestWorkflowWithAncillaries:
    """Config 4: DEM shadow + landcover + ocean masking end-to-end."""

    @pytest.fixture(scope='class')
    def outputs(self, tmp_path_factory):
        root = tmp_path_factory.mktemp('wfanc')
        input_dir = str(root / 'input')
        output_dir = str(root / 'output')
        scratch_dir = str(root / 'scratch')
        size = 240
        files, bands = synthetic.make_hls_v2_dataset(input_dir, size=size)
        dem = synthetic.make_dem(str(root), size=size)
        lc = synthetic.make_landcover(str(root), size=size)
        wc = synthetic.make_worldcover(str(root), size=size)
        shore = synthetic.make_shoreline(str(root), size=size)
        rc = synthetic.write_runconfig(
            str(root / 'rc.yaml'), input_dir, output_dir, scratch_dir,
            dem_file=dem, landcover_file=lc, worldcover_file=wc,
            shoreline_shapefile=shore, check_coverage=True,
            apply_ocean_masking=True)
        dswx_hls_main([rc])
        return output_dir, bands, size

    def test_all_ten_layers_exist(self, outputs):
        output_dir, _, _ = outputs
        for nn, layer in enumerate(['WTR', 'BWTR', 'CONF', 'DIAG',
                                    'WTR-1', 'WTR-2', 'LAND', 'SHAD',
                                    'CLOUD', 'DEM'], start=1):
            path = os.path.join(
                output_dir, f'dswx_hls_test_v0.1_B{nn:02}_{layer}.tif')
            assert os.path.isfile(path), path
            assert validate_cog(path) == [], path

    def test_ocean_is_masked(self, outputs):
        output_dir, _, size = outputs
        path = os.path.join(output_dir, 'dswx_hls_test_v0.1_B01_WTR.tif')
        with TiffReader(path) as r:
            wtr = r.read()
        # the east 40% of the tile is ocean (masked as 254); the shoreline
        # margin shifts the boundary east->west by 1 km
        assert (wtr[:, -int(size * 0.25):] == 254).mean() > 0.95
        assert (wtr[:, :int(size * 0.5)] != 254).all()

    def test_dem_layer_roundtrip(self, outputs):
        output_dir, _, _ = outputs
        path = os.path.join(output_dir, 'dswx_hls_test_v0.1_B10_DEM.tif')
        with TiffReader(path) as r:
            dem = r.read()
            assert dem.dtype == np.float32
        assert np.isfinite(dem).all()
        assert dem.std() > 1.0

    def test_shad_is_binary(self, outputs):
        output_dir, _, _ = outputs
        path = os.path.join(output_dir, 'dswx_hls_test_v0.1_B08_SHAD.tif')
        with TiffReader(path) as r:
            shad = r.read()
        assert set(np.unique(shad)) <= {0, 1}

    def test_land_classes(self, outputs):
        output_dir, _, _ = outputs
        path = os.path.join(output_dir, 'dswx_hls_test_v0.1_B07_LAND.tif')
        with TiffReader(path) as r:
            land = r.read()
        valid_classes = set(range(0, 200)) | {200, 201, 255}
        assert set(np.unique(land)) <= valid_classes
        assert (land != 255).any()


def test_l30_landsat_ingest(tmp_path):
    """L30 products: Landsat band names (B05/B06/B07) and platform
    detection from SENSOR + LANDSAT_PRODUCT_ID."""
    files, bands = synthetic.make_hls_v2_dataset(
        str(tmp_path / 'in'), size=96, product='L30')
    out = str(tmp_path / 'wtr_l30.tif')
    from proteus_jax.runtime.orchestrator import generate_dswx_layers
    ok = generate_dswx_layers(files, output_interpreted_band=out,
                              check_ancillary_inputs_coverage=False,
                              apply_ocean_masking=False)
    assert ok
    with TiffReader(out) as r:
        md = r.metadata()
        wtr = r.read()
    assert md['SPACECRAFT_NAME'] == 'Landsat-8'
    assert md['SENSOR'] == 'OLI'
    assert md['SENSOR_PRODUCT_ID'].startswith('LC08')
    # golden comparison against the oracle (L30 band mapping)
    invalid = np.zeros(bands['B02'].shape, bool)
    arrs = {}
    for key, name in [('blue', 'B02'), ('green', 'B03'), ('red', 'B04'),
                      ('nir', 'B05'), ('swir1', 'B06'),
                      ('swir2', 'B07')]:
        invalid |= (bands[name] == -9999)
        arrs[key] = np.clip(bands[name], 1, None)
    want = oracle.full_chain(arrs['blue'], arrs['green'], arrs['red'],
                             arrs['nir'], arrs['swir1'], arrs['swir2'],
                             bands['Fmask'], invalid, TDICT,
                             aerosol_lists=AEROSOL_LISTS)
    np.testing.assert_array_equal(wtr, oracle.collapse(want['WTR']))
