"""Runconfig precedence, derived paths, and ingest error paths."""

import argparse
import os

import numpy as np
import pytest

import synthetic

from proteus_jax.config.runconfig import (deep_update, load_runconfig,
                                          parse_runconfig_file)
from proteus_jax.io import hls as hls_io


def _args():
    ns = argparse.Namespace()
    for name in ('dem_file', 'dem_file_description', 'landcover_file',
                 'landcover_file_description', 'worldcover_file',
                 'worldcover_file_description', 'shoreline_shapefile',
                 'shoreline_shapefile_description', 'scratch_dir',
                 'product_id', 'product_version', 'output_browse_image'):
        setattr(ns, name, None)
    from proteus_jax.core import constants as C
    for arg in C.LAYER_NAMES_TO_ARGS_DICT.values():
        setattr(ns, arg, None)
    return ns


def test_defaults_loaded():
    rc = parse_runconfig_file()
    assert rc.hls_thresholds.wigt == 0.124
    assert rc.shadow_masking_algorithm == 'sun_local_inc_angle'
    assert rc.mask_adjacent_to_cloud_mode == 'mask'
    assert rc.check_ancillary_inputs_coverage is True
    assert rc.browse_image_height == 1024


def test_user_overrides_defaults(tmp_path):
    rcfile = synthetic.write_runconfig(
        str(tmp_path / 'rc.yaml'), str(tmp_path), str(tmp_path),
        str(tmp_path),
        extra_processing={'mask_adjacent_to_cloud_mode': "'cover'",
                          'min_slope_angle': -10})
    args = _args()
    rc = parse_runconfig_file(rcfile, args)
    assert rc.mask_adjacent_to_cloud_mode == 'cover'
    assert rc.min_slope_angle == -10
    # unset values keep defaults
    assert rc.max_sun_local_inc_angle == 40


def test_derived_layer_paths(tmp_path):
    rcfile = synthetic.write_runconfig(
        str(tmp_path / 'rc.yaml'), str(tmp_path), str(tmp_path / 'out'),
        str(tmp_path))
    args = _args()
    parse_runconfig_file(rcfile, args)
    assert args.output_interpreted_band.endswith(
        'dswx_hls_test_v0.1_B01_WTR.tif')
    assert args.output_dem_layer.endswith(
        'dswx_hls_test_v0.1_B10_DEM.tif')
    assert args.output_browse_image.endswith(
        'dswx_hls_test_v0.1_BROWSE.png')


def test_cli_precedence_over_runconfig(tmp_path):
    rcfile = synthetic.write_runconfig(
        str(tmp_path / 'rc.yaml'), str(tmp_path), str(tmp_path / 'out'),
        str(tmp_path))
    args = _args()
    args.output_interpreted_band = '/custom/wtr.tif'
    args.product_id = 'custom_pid'
    parse_runconfig_file(rcfile, args)
    assert args.output_interpreted_band == '/custom/wtr.tif'
    assert args.product_id == 'custom_pid'


def test_deep_update_none_does_not_override():
    main = {'a': {'b': 1, 'c': 2}}
    out = deep_update(main, {'a': {'b': None, 'c': 3}})
    assert out['a']['b'] == 1 and out['a']['c'] == 3


def test_missing_runconfig_raises():
    with pytest.raises(Exception):
        parse_runconfig_file('/no/such/runconfig.yaml')


class TestIngestErrors:
    def test_missing_band_returns_none(self, tmp_path):
        files, _ = synthetic.make_hls_v2_dataset(str(tmp_path), size=32)
        files = [f for f in files if 'B03' not in f]
        out = hls_io.load_hls_product_v2(files, {}, {}, {}, {}, False)
        assert out is None

    def test_unsupported_platform_returns_false(self, tmp_path):
        from proteus_jax.io.cog import write_cog
        md = dict(synthetic.HLS_METADATA)
        md['SPACECRAFT_NAME'] = 'Terra'
        files = []
        for b in ('B02', 'B03', 'B04', 'B8A', 'B11', 'B12', 'Fmask'):
            p = str(tmp_path / f'X.{b}.tif')
            write_cog(p, np.ones((16, 16), np.int16),
                      geotransform=synthetic.geotransform(),
                      epsg=32615, nodata=-9999, metadata=md,
                      overview_levels=())
            files.append(p)
        out = hls_io.load_hls_product_v2(files, {}, {}, {}, {}, False)
        assert out is False

    def test_unreadable_file_returns_none(self, tmp_path):
        bad = str(tmp_path / 'X.B02.tif')
        open(bad, 'w').write('junk')
        out = hls_io.load_hls_band(bad, {}, {}, {}, {}, 'blue', False)
        assert out is None
