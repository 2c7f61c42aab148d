"""HDF4 reader/writer round-trips and the HLS v1 ingest path."""

import numpy as np
import pytest

import synthetic

from proteus_jax.io import hdf4
from hdf4_writer import Hdf4Writer, make_struct_metadata

RNG = np.random.default_rng(17)


@pytest.mark.parametrize('compress,chunked', [(False, False),
                                              (True, False),
                                              (True, True)])
def test_sds_roundtrip(tmp_path, compress, chunked):
    w = Hdf4Writer()
    arr = RNG.integers(-5000, 15000, (200, 130)).astype(np.int16)
    w.add_sds('band02', arr, attrs={'_FillValue':
                                    np.array([-9999], np.int16)},
              compress=compress, chunked=chunked, chunk_dims=[64, 64])
    w.add_global_attr('SENSING_TIME', '2021-07-29T16:38:19Z')
    path = str(tmp_path / 'x.hdf')
    w.save(path)

    assert hdf4.is_hdf4(path)
    with hdf4.Hdf4File(path) as f:
        ds = f.datasets()
        assert 'band02' in ds
        got = f.read_sds('band02')
        np.testing.assert_array_equal(got, arr)
        win = f.read_sds('band02', window=(10, 20, 50, 60))
        np.testing.assert_array_equal(win, arr[10:60, 20:80])
        ga = f.global_attributes()
        assert ga['SENSING_TIME'] == '2021-07-29T16:38:19Z'
        fv = ds['band02'][3]['_FillValue']
        assert int(fv[0]) == -9999


@pytest.mark.parametrize('dtype', [np.uint8, np.int32, np.float32])
def test_sds_dtypes(tmp_path, dtype):
    """Non-int16 SDS dtypes (v1 QA/Fmask bands are uint8; angles float)."""
    w = Hdf4Writer()
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        arr = RNG.integers(info.min, min(info.max, 10000),
                           (64, 96)).astype(dtype)
    else:
        arr = RNG.normal(0, 100, (64, 96)).astype(dtype)
    w.add_sds('layer', arr, compress=True)
    path = str(tmp_path / 'd.hdf')
    w.save(path)
    with hdf4.Hdf4File(path) as f:
        got = f.read_sds('layer')
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, arr)


def test_linked_block_layouts(tmp_path):
    """Spec 'Linked Block Elements' (hblocks): block tables chaining
    data blocks, for both a plain SDS and the compressed stream of a
    DEFLATE SDS (the appendable-element layout real HDF4 produces when
    an element grows incrementally)."""
    arr = RNG.integers(-5000, 15000, (90, 77)).astype(np.int16)
    for kw in ({'compress': False, 'linked': True},
               {'compress': True, 'linked_comp': True}):
        w = Hdf4Writer()
        w.add_sds('band02', arr, **kw)
        path = str(tmp_path / 'l.hdf')
        w.save(path)
        with hdf4.Hdf4File(path) as f:
            np.testing.assert_array_equal(f.read_sds('band02'), arr)


def test_multiblock_dd_chain(tmp_path):
    """DD lists split across several linked DD blocks (the real
    library grows the list in fixed-size blocks)."""
    w = Hdf4Writer()
    arrs = {}
    for i in range(4):
        arrs[f'b{i}'] = RNG.integers(0, 1000, (40, 33)).astype(np.int16)
        w.add_sds(f'b{i}', arrs[f'b{i}'], compress=(i % 2 == 0))
    w.add_global_attr('SENSING_TIME', '2020-01-01T00:00:00Z')
    path = str(tmp_path / 'm.hdf')
    w.save(path, dd_block_size=3)
    with hdf4.Hdf4File(path) as f:
        for name, arr in arrs.items():
            np.testing.assert_array_equal(f.read_sds(name), arr)
        assert f.global_attributes()['SENSING_TIME'].startswith('2020')


def test_sparse_chunked_sds(tmp_path):
    """Chunk-table records with null tag/ref (unwritten chunks) read
    back as zeros instead of raising."""
    w = Hdf4Writer()
    arr = RNG.integers(1, 100, (100, 100)).astype(np.int16)
    w.add_sds('band02', arr, compress=True, chunked=True,
              chunk_dims=[64, 64], sparse_origins=[(1, 1)])
    path = str(tmp_path / 's.hdf')
    w.save(path)
    want = arr.copy()
    want[64:, 64:] = 0
    with hdf4.Hdf4File(path) as f:
        np.testing.assert_array_equal(f.read_sds('band02'), want)


def test_struct_metadata_parse():
    text = make_struct_metadata(699960.0, 3300000.0, 809760.0,
                                3190200.0, 3660, 3660, 15)
    gt, zone, (h, w) = hdf4.parse_struct_metadata(text)
    assert zone == 15 and (h, w) == (3660, 3660)
    assert gt[0] == 699960.0 and gt[1] == 30.0 and gt[5] == -30.0


def test_hdf4_raster_adapter(tmp_path):
    path, bands = synthetic.make_hls_v1_dataset(str(tmp_path), size=96)
    r = hdf4.Hdf4Raster(path, 'band03')
    with r:
        arr = r.read()
        np.testing.assert_array_equal(arr, bands['B03'])
        assert r.nodata() == -9999.0
        md = r.metadata()
        assert md['SPACECRAFT_NAME'] == 'SENTINEL-2A'
        assert float(md['scale_factor']) == 0.0001
        gt = r.geotransform()
        assert gt[1] == 30.0
        assert '32615' in r.projection()


def test_v1_ingest_end_to_end(tmp_path):
    """Full orchestrator run from an HLS v1 HDF4 product."""
    import oracle
    from proteus_jax.core.thresholds import HlsThresholds
    from proteus_jax.io.tiff import TiffReader
    from proteus_jax.runtime.orchestrator import generate_dswx_layers

    path, bands = synthetic.make_hls_v1_dataset(str(tmp_path), size=96)
    out = str(tmp_path / 'wtr_v1.tif')
    ok = generate_dswx_layers([path], output_interpreted_band=out,
                              check_ancillary_inputs_coverage=False,
                              apply_ocean_masking=False)
    assert ok
    t = HlsThresholds()
    tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
    invalid = np.zeros(bands['B02'].shape, bool)
    arrs = {}
    for key, name in [('blue', 'B02'), ('green', 'B03'), ('red', 'B04'),
                      ('nir', 'B8A'), ('swir1', 'B11'),
                      ('swir2', 'B12')]:
        invalid |= (bands[name] == -9999)
        arrs[key] = np.clip(bands[name], 1, None)
    lists = {0: [224, 160, 96], 2: [224, 160, 96],
             3: [224, 192, 160, 128, 96], 4: [224, 192, 160, 128, 96]}
    want = oracle.full_chain(arrs['blue'], arrs['green'], arrs['red'],
                             arrs['nir'], arrs['swir1'], arrs['swir2'],
                             bands['Fmask'], invalid, tdict,
                             aerosol_lists=lists)
    with TiffReader(out) as r:
        got = r.read()
    np.testing.assert_array_equal(got, oracle.collapse(want['WTR']))
