"""End-to-end: the REFERENCE's orchestrator runs on this repo's engines.

tests/gdal_shim.py provides a functional subset of the osgeo API backed
by proteus_jax's own I/O, warp, and CRS engines. Injecting it into the
refbridge-loaded reference module lets the reference's real
``generate_dswx_layers`` (dswx_hls.py:4610) execute end-to-end — ingest,
ancillary warps, science, 10-band product write, browse PNG — on a
synthetic scene. Its products are then compared file-by-file against
this repo's orchestrator given the *same* arguments.

This is the strongest golden validation available offline: every
orchestration, science, metadata, and packaging decision of the
reference's executing code must coincide bit-for-bit with ours (GDAL's
internal raster codecs are the only part not exercised — both sides
write through this repo's COG writer).
"""

import glob
import os
import sys

import numpy as np
import pytest

import gdal_shim
import refbridge
import synthetic

from proteus_jax.config.runconfig import parse_runconfig_file
from proteus_jax.io.cog import save_as_cog as our_save_as_cog
from proteus_jax.runtime.compare import compare_dswx_hls_products
from proteus_jax.runtime import orchestrator

REF = refbridge.load_reference_dswx()

pytestmark = pytest.mark.skipif(
    REF is None, reason='reference checkout not available')


@pytest.fixture()
def ref_with_shims():
    """Inject the functional GDAL shims into the reference module,
    restoring the inert refbridge stubs afterwards."""
    saved = {name: getattr(REF, name)
             for name in ('gdal', 'osr', 'ogr', 'save_as_cog',
                          'GDT_Byte', 'GDT_Float32')}
    g, o, r = gdal_shim.make_modules()
    REF.gdal = g
    REF.osr = o
    REF.ogr = r
    REF.save_as_cog = our_save_as_cog
    # `from osgeo.gdalconst import GDT_Float32, GDT_Byte` (dswx_hls.py:12)
    REF.GDT_Byte = gdal_shim.GDT_Byte
    REF.GDT_Float32 = gdal_shim.GDT_Float32
    try:
        yield REF
    finally:
        for name, value in saved.items():
            setattr(REF, name, value)


def _common_kwargs(product_id):
    rc = parse_runconfig_file()
    t = rc.hls_thresholds
    ref_t = refbridge.reference_thresholds(
        {k: getattr(t, k) for k in t.__dataclass_fields__})
    common = dict(
        product_id=product_id,
        product_version='0.1',
        check_ancillary_inputs_coverage=False,
        apply_ocean_masking=False,
        apply_aerosol_class_remapping=rc.apply_aerosol_class_remapping,
        aerosol_not_water_to_high_conf_water_fmask_values=(
            rc.aerosol_not_water_to_high_conf_water_fmask_values),
        aerosol_water_moderate_conf_to_high_conf_water_fmask_values=(
            rc.aerosol_water_moderate_conf_to_high_conf_water_fmask_values),
        aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values=(
            rc.aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values),
        aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values=(
            rc.aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values),
        shadow_masking_algorithm='sun_local_inc_angle',
        min_slope_angle=rc.min_slope_angle,
        max_sun_local_inc_angle=rc.max_sun_local_inc_angle,
        mask_adjacent_to_cloud_mode=rc.mask_adjacent_to_cloud_mode,
        forest_mask_landcover_classes=rc.forest_mask_landcover_classes,
        ocean_masking_shoreline_distance_km=(
            rc.ocean_masking_shoreline_distance_km),
        browse_image_height=256,
        browse_image_width=256,
        exclude_psw_aggressive_in_browse=(
            rc.exclude_psw_aggressive_in_browse),
        not_water_in_browse=rc.not_water_in_browse,
        cloud_in_browse=rc.cloud_in_browse,
        snow_in_browse=rc.snow_in_browse,
    )
    return common, ref_t, t


def _compare_trees(ref_dir, our_dir):
    ref_files = sorted(os.path.basename(f)
                       for f in glob.glob(os.path.join(ref_dir, '*')))
    our_files = sorted(os.path.basename(f)
                       for f in glob.glob(os.path.join(our_dir, '*')))
    assert ref_files, 'reference run produced no outputs'
    assert ref_files == our_files, (
        f'output sets differ:\n ref: {ref_files}\n ours: {our_files}')
    for name in ref_files:
        ref_path = os.path.join(ref_dir, name)
        our_path = os.path.join(our_dir, name)
        if name.endswith('.png'):
            with open(ref_path, 'rb') as fa, open(our_path, 'rb') as fb:
                assert fa.read() == fb.read(), f'browse PNG differs: {name}'
        else:
            assert compare_dswx_hls_products(ref_path, our_path), (
                f'product differs: {name}')


def _per_layer_outputs(out_dir):
    """Per-layer product paths (the reference's single 10-band
    ``output_file`` write has no None-band guard — dswx_hls.py:2679-2691
    — so it is only usable when every ancillary layer exists)."""
    return dict(
        output_interpreted_band=os.path.join(out_dir, 'wtr.tif'),
        output_binary_water=os.path.join(out_dir, 'bwtr.tif'),
        output_confidence_layer=os.path.join(out_dir, 'conf.tif'),
        output_diagnostic_layer=os.path.join(out_dir, 'diag.tif'),
        output_non_masked_dswx=os.path.join(out_dir, 'wtr1.tif'),
        output_shadow_masked_dswx=os.path.join(out_dir, 'wtr2.tif'),
        output_cloud_layer=os.path.join(out_dir, 'cloud.tif'),
        output_browse_image=os.path.join(out_dir, 'browse.png'),
    )


class TestReferenceEndToEnd:
    @pytest.mark.parametrize('product', ['S30', 'L30'])
    def test_core_layers_no_ancillaries(self, ref_with_shims, tmp_path,
                                        product):
        # 720 px: products span a 2x2 grid of 512-px COG tiles, so the
        # comparison also covers multi-tile layout (360 is single-tile)
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir, size=720,
                                                      product=product)
        ref_dir = str(tmp_path / 'ref_out')
        our_dir = str(tmp_path / 'our_out')
        ref_scratch = str(tmp_path / 'ref_scratch')
        our_scratch = str(tmp_path / 'our_scratch')
        for d in (ref_dir, our_dir, ref_scratch, our_scratch):
            os.makedirs(d)
        common, ref_t, our_t = _common_kwargs('dswx_e2e')

        def outputs(out_dir):
            out = _per_layer_outputs(out_dir)
            out.update(
                output_rgb_file=os.path.join(out_dir, 'rgb.tif'),
                output_infrared_rgb_file=os.path.join(
                    out_dir, 'infrared_rgb.tif'))
            return out

        ret = ref_with_shims.generate_dswx_layers(
            list(files), hls_thresholds=ref_t,
            scratch_dir=ref_scratch, **outputs(ref_dir), **common)
        assert ret, 'reference generate_dswx_layers reported failure'

        ret = orchestrator.generate_dswx_layers(
            list(files), hls_thresholds=our_t,
            scratch_dir=our_scratch, **outputs(our_dir), **common)
        assert ret

        _compare_trees(ref_dir, our_dir)

    def test_core_layers_scaled_inputs(self, ref_with_shims, tmp_path):
        """--offset-and-scale-inputs mode: the whole science chain runs
        on float32 scaled reflectance in both implementations (the
        reference casts at ingest, dswx_hls.py:2298-2302; our device path
        uses the division-free exact boundary comparisons)."""
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir, size=360)
        ref_dir = str(tmp_path / 'ref_out')
        our_dir = str(tmp_path / 'our_out')
        ref_scratch = str(tmp_path / 'ref_scratch')
        our_scratch = str(tmp_path / 'our_scratch')
        for d in (ref_dir, our_dir, ref_scratch, our_scratch):
            os.makedirs(d)
        common, ref_t, our_t = _common_kwargs('dswx_e2e_scaled')

        ret = ref_with_shims.generate_dswx_layers(
            list(files), hls_thresholds=ref_t,
            flag_offset_and_scale_inputs=True,
            scratch_dir=ref_scratch, **_per_layer_outputs(ref_dir),
            **common)
        assert ret, 'reference generate_dswx_layers reported failure'

        ret = orchestrator.generate_dswx_layers(
            list(files), hls_thresholds=our_t,
            flag_offset_and_scale_inputs=True,
            scratch_dir=our_scratch, **_per_layer_outputs(our_dir),
            **common)
        assert ret

        _compare_trees(ref_dir, our_dir)

    def test_layers_with_dem_and_landcover(self, ref_with_shims,
                                           tmp_path):
        """Full ancillary run compared per layer, including LAND, SHAD
        and the float32 DEM layer (CUBICSPLINE overviews on both sides).

        Our orchestrator runs its PRODUCTION device-warp path, which is
        bit-identical to the host float64 warp the shim routes the
        reference through (double-f32 coordinates and accumulation +
        host resolve of the boundary-ambiguity band) — every layer,
        including the cubic-warped float32 DEM, must match exactly.
        """
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir, size=360)
        for d in ('dem', 'lc', 'wc'):
            os.makedirs(str(tmp_path / d))
        dem_file = synthetic.make_dem(str(tmp_path / 'dem'), size=360)
        landcover_file = synthetic.make_landcover(
            str(tmp_path / 'lc'), size=360)
        worldcover_file = synthetic.make_worldcover(
            str(tmp_path / 'wc'), size=360)
        ref_dir = str(tmp_path / 'ref_out')
        our_dir = str(tmp_path / 'our_out')
        ref_scratch = str(tmp_path / 'ref_scratch')
        our_scratch = str(tmp_path / 'our_scratch')
        for d in (ref_dir, our_dir, ref_scratch, our_scratch):
            os.makedirs(d)
        common, ref_t, our_t = _common_kwargs('dswx_e2e_anc')

        anc = dict(dem_file=dem_file, landcover_file=landcover_file,
                   worldcover_file=worldcover_file)

        def extra_outputs(out_dir):
            out = _per_layer_outputs(out_dir)
            out.update(
                output_landcover=os.path.join(out_dir, 'land.tif'),
                output_shadow_layer=os.path.join(out_dir, 'shad.tif'),
                output_dem_layer=os.path.join(out_dir, 'dem.tif'))
            return out

        ret = ref_with_shims.generate_dswx_layers(
            list(files), hls_thresholds=ref_t,
            scratch_dir=ref_scratch, **extra_outputs(ref_dir),
            **anc, **common)
        assert ret, 'reference generate_dswx_layers reported failure'

        ret = orchestrator.generate_dswx_layers(
            list(files), hls_thresholds=our_t,
            scratch_dir=our_scratch, **extra_outputs(our_dir),
            **anc, **common)
        assert ret

        _compare_trees(ref_dir, our_dir)

    def test_layers_with_equal_area_dem(self, ref_with_shims, tmp_path):
        """A DEM delivered in NAD83 Conus Albers (EPSG:5070, the NLCD/
        LANDFIRE grid — round-3 CRS widening): the REFERENCE's own
        orchestrator executes its gdal.Warp call over our Albers engine
        and must agree layer-for-layer with our production device-warp
        path (reference accepts any OSR SRS, dswx_hls.py:3385-3461)."""
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir, size=360)
        os.makedirs(str(tmp_path / 'dem'))
        dem_file = synthetic.make_dem_in_crs(
            str(tmp_path / 'dem'), epsg=5070, size=360)
        ref_dir = str(tmp_path / 'ref_out')
        our_dir = str(tmp_path / 'our_out')
        ref_scratch = str(tmp_path / 'ref_scratch')
        our_scratch = str(tmp_path / 'our_scratch')
        for d in (ref_dir, our_dir, ref_scratch, our_scratch):
            os.makedirs(d)
        common, ref_t, our_t = _common_kwargs('dswx_e2e_ea')

        def extra_outputs(out_dir):
            out = _per_layer_outputs(out_dir)
            out.update(
                output_shadow_layer=os.path.join(out_dir, 'shad.tif'),
                output_dem_layer=os.path.join(out_dir, 'dem.tif'))
            return out

        ret = ref_with_shims.generate_dswx_layers(
            list(files), hls_thresholds=ref_t, dem_file=dem_file,
            scratch_dir=ref_scratch, **extra_outputs(ref_dir),
            **common)
        assert ret, 'reference generate_dswx_layers reported failure'

        ret = orchestrator.generate_dswx_layers(
            list(files), hls_thresholds=our_t, dem_file=dem_file,
            scratch_dir=our_scratch, **extra_outputs(our_dir),
            **common)
        assert ret

        _compare_trees(ref_dir, our_dir)

    def test_otsu_shadow_branch(self, ref_with_shims, tmp_path):
        """The reference's 'otsu' shadow algorithm — gdal.DEMProcessing
        hillshade (shimmed onto our Horn kernel) + its Otsu threshold +
        crop — executes end-to-end and the shadow-dependent layers match
        our orchestrator's otsu path."""
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir, size=360)
        os.makedirs(str(tmp_path / 'dem'))
        dem_file = synthetic.make_dem(str(tmp_path / 'dem'), size=360)
        ref_dir = str(tmp_path / 'ref_out')
        our_dir = str(tmp_path / 'our_out')
        ref_scratch = str(tmp_path / 'ref_scratch')
        our_scratch = str(tmp_path / 'our_scratch')
        for d in (ref_dir, our_dir, ref_scratch, our_scratch):
            os.makedirs(d)
        common, ref_t, our_t = _common_kwargs('dswx_e2e_otsu')
        common['shadow_masking_algorithm'] = 'otsu'

        def outs(out_dir):
            return dict(
                output_interpreted_band=os.path.join(out_dir, 'wtr.tif'),
                output_shadow_masked_dswx=os.path.join(out_dir,
                                                       'wtr2.tif'),
                output_shadow_layer=os.path.join(out_dir, 'shad.tif'))

        ret = ref_with_shims.generate_dswx_layers(
            list(files), hls_thresholds=ref_t, dem_file=dem_file,
            scratch_dir=ref_scratch, **outs(ref_dir), **common)
        assert ret, 'reference generate_dswx_layers reported failure'
        ret = orchestrator.generate_dswx_layers(
            list(files), hls_thresholds=our_t, dem_file=dem_file,
            scratch_dir=our_scratch, **outs(our_dir), **common)
        assert ret
        from proteus_jax.io.tiff import TiffReader
        with TiffReader(os.path.join(our_dir, 'shad.tif')) as r:
            shad = r.read()
        assert set(np.unique(shad)) <= {0, 1}
        assert (shad == 0).any() and (shad == 1).any()
        _compare_trees(ref_dir, our_dir)

    def test_hls_v1_hdf4_ingest(self, ref_with_shims, tmp_path):
        """HLS v1 (HDF4-EOS): the reference's _load_hls_product_v1 opens
        HDF4_EOS:EOS_GRID subdataset refs (dswx_hls.py:2358) — routed by
        the shim to this repo's HDF4 reader — and runs the whole product
        generation. Its outputs must match our orchestrator ingesting
        the same v1 granule natively (io/hls.py + io/hdf4.py)."""
        v1_path, _bands = synthetic.make_hls_v1_dataset(
            str(tmp_path / 'input'), size=360)
        ref_dir = str(tmp_path / 'ref_out')
        our_dir = str(tmp_path / 'our_out')
        ref_scratch = str(tmp_path / 'ref_scratch')
        our_scratch = str(tmp_path / 'our_scratch')
        for d in (ref_dir, our_dir, ref_scratch, our_scratch):
            os.makedirs(d)
        common, ref_t, our_t = _common_kwargs('dswx_e2e_v1')

        ret = ref_with_shims.generate_dswx_layers(
            [v1_path], hls_thresholds=ref_t,
            scratch_dir=ref_scratch, **_per_layer_outputs(ref_dir),
            **common)
        assert ret, 'reference generate_dswx_layers reported failure'

        ret = orchestrator.generate_dswx_layers(
            [v1_path], hls_thresholds=our_t,
            scratch_dir=our_scratch, **_per_layer_outputs(our_dir),
            **common)
        assert ret

        _compare_trees(ref_dir, our_dir)

    def test_layers_with_ocean_masking(self, ref_with_shims, tmp_path):
        """Ocean masking: the reference's _create_ocean_mask
        (dswx_hls.py:3464-3572) executes through the ogr/RasterizeLayer
        shim — shapefile read, per-polygon intersection, SRS transform,
        metric buffer, rasterize, OR-accumulate — over this repo's
        engines, and the masked products (WTR ocean class 254, coverage
        metadata) must match our orchestrator. The buffer itself runs as
        the exact Euclidean distance threshold on BOTH sides (the
        production semantics; GEOS's 30-segment arc approximation is a
        documented deviation, COMPONENTS.md)."""
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir, size=360)
        os.makedirs(str(tmp_path / 'shore'))
        shoreline = synthetic.make_shoreline(str(tmp_path / 'shore'),
                                             size=360)
        ref_dir = str(tmp_path / 'ref_out')
        our_dir = str(tmp_path / 'our_out')
        ref_scratch = str(tmp_path / 'ref_scratch')
        our_scratch = str(tmp_path / 'our_scratch')
        for d in (ref_dir, our_dir, ref_scratch, our_scratch):
            os.makedirs(d)
        common, ref_t, our_t = _common_kwargs('dswx_e2e_ocean')
        common['apply_ocean_masking'] = True

        ret = ref_with_shims.generate_dswx_layers(
            list(files), hls_thresholds=ref_t,
            shoreline_shapefile=shoreline,
            scratch_dir=ref_scratch, **_per_layer_outputs(ref_dir),
            **common)
        assert ret, 'reference generate_dswx_layers reported failure'

        ret = orchestrator.generate_dswx_layers(
            list(files), hls_thresholds=our_t,
            shoreline_shapefile=shoreline,
            scratch_dir=our_scratch, **_per_layer_outputs(our_dir),
            **common)
        assert ret

        # the mask must actually bite: ocean class present in WTR
        from proteus_jax.io.tiff import TiffReader
        with TiffReader(os.path.join(our_dir, 'wtr.tif')) as r:
            assert (r.read() == 254).any(), 'no ocean-masked pixels'

        _compare_trees(ref_dir, our_dir)

    def test_ancillary_coverage_checks(self, ref_with_shims, tmp_path):
        """check_ancillary_inputs_coverage=True: the reference's
        _check_ancillary_inputs (dswx_hls.py:4340-4607) executes over the
        shim geometry — full coverage passes on both sides; a DEM that
        does not cover the tile makes both implementations raise."""
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir, size=360)
        for d in ('dem', 'lc', 'wc', 'dem_small'):
            os.makedirs(str(tmp_path / d))
        anc = dict(
            dem_file=synthetic.make_dem(str(tmp_path / 'dem'), size=360),
            landcover_file=synthetic.make_landcover(
                str(tmp_path / 'lc'), size=360),
            worldcover_file=synthetic.make_worldcover(
                str(tmp_path / 'wc'), size=360))
        common, ref_t, our_t = _common_kwargs('dswx_e2e_cov')
        common['check_ancillary_inputs_coverage'] = True

        ref_dir = str(tmp_path / 'ref_out')
        our_dir = str(tmp_path / 'our_out')
        ref_scratch = str(tmp_path / 'ref_scratch')
        our_scratch = str(tmp_path / 'our_scratch')
        for d in (ref_dir, our_dir, ref_scratch, our_scratch):
            os.makedirs(d)
        ret = ref_with_shims.generate_dswx_layers(
            list(files), hls_thresholds=ref_t, scratch_dir=ref_scratch,
            output_interpreted_band=os.path.join(ref_dir, 'wtr.tif'),
            **anc, **common)
        assert ret
        ret = orchestrator.generate_dswx_layers(
            list(files), hls_thresholds=our_t, scratch_dir=our_scratch,
            output_interpreted_band=os.path.join(our_dir, 'wtr.tif'),
            **anc, **common)
        assert ret
        _compare_trees(ref_dir, our_dir)

        # a DEM covering only half the tile: both sides must raise
        from proteus_jax.io.tiff import TiffReader
        from proteus_jax.io.cog import write_cog
        with TiffReader(anc['dem_file']) as r:
            dem = r.read()
            gt = r.geotransform()
        half = dem[:dem.shape[0] // 2]
        small = os.path.join(str(tmp_path / 'dem_small'), 'dem.tif')
        write_cog(small, half, geotransform=gt, epsg=4326,
                  nodata=float('nan'), overview_levels=())
        bad = dict(anc, dem_file=small)
        with pytest.raises(ValueError):
            ref_with_shims.generate_dswx_layers(
                list(files), hls_thresholds=ref_t,
                scratch_dir=ref_scratch, **bad, **common)
        with pytest.raises(ValueError):
            orchestrator.generate_dswx_layers(
                list(files), hls_thresholds=our_t,
                scratch_dir=our_scratch, **bad, **common)

    def test_reference_runconfig_parser_on_our_engines(self,
                                                       ref_with_shims,
                                                       tmp_path):
        """The reference's parse_runconfig_file (dswx_hls.py:3601)
        executes with yamale backed by our config/validator engine and
        ruamel backed by PyYAML: the reference's own schema validates a
        user runconfig, its deep-merge and constants extraction run, and
        every resulting RunConfigConstants field (incl. thresholds)
        matches our parser on the same file. A schema-violating
        runconfig is rejected by both."""
        import types
        import yaml as pyyaml
        from proteus_jax.config import validator as v

        def _make_schema(path, parser=None):
            return v.load_schema(path)

        def _make_data(path, parser=None):
            with open(path) as fh:
                return [(pyyaml.safe_load(fh), path)]

        def _validate(schema, data):
            for d, _path in data:
                v.validate(d, schema[0], schema[1])

        yam = types.SimpleNamespace(
            make_schema=_make_schema, make_data=_make_data,
            validate=_validate, YamaleError=v.SchemaError)

        class _RuamelYaml:
            def __init__(self, typ=None):
                pass

            def load(self, stream):
                return pyyaml.safe_load(stream)

        saved = (REF.yamale, REF.ruamel_yaml)
        REF.yamale = yam
        REF.ruamel_yaml = _RuamelYaml
        try:
            rc_path = str(tmp_path / 'rc.yaml')
            synthetic.write_runconfig(
                rc_path, str(tmp_path / 'in'), str(tmp_path / 'out'),
                str(tmp_path / 'scratch'),
                extra_processing={'mask_adjacent_to_cloud_mode':
                                  'cover'},
                thresholds={'wigt': 0.2, 'pswt_1_nir': 1400})
            ref_rc = ref_with_shims.parse_runconfig_file(rc_path)
            our_rc = parse_runconfig_file(user_runconfig_file=rc_path)
            from proteus_jax.config.runconfig import RunConfigConstants
            for field in RunConfigConstants.__dataclass_fields__:
                if field == 'hls_thresholds':
                    continue
                assert getattr(our_rc, field) == getattr(ref_rc, field), \
                    field
            for key in our_rc.hls_thresholds.__dataclass_fields__:
                assert getattr(our_rc.hls_thresholds, key) == \
                    getattr(ref_rc.hls_thresholds, key), key
            assert ref_rc.mask_adjacent_to_cloud_mode == 'cover'
            assert ref_rc.hls_thresholds.wigt == 0.2

            # schema violation: both sides must reject
            bad_path = str(tmp_path / 'bad.yaml')
            with open(rc_path) as fh:
                rc_text = fh.read()
            assert 'mask_adjacent_to_cloud_mode: cover' in rc_text
            with open(bad_path, 'w') as fh:
                fh.write(rc_text.replace(
                    'mask_adjacent_to_cloud_mode: cover',
                    'mask_adjacent_to_cloud_mode: 42'))
            with pytest.raises(Exception):
                ref_with_shims.parse_runconfig_file(bad_path)
            with pytest.raises(Exception):
                parse_runconfig_file(user_runconfig_file=bad_path)
        finally:
            REF.yamale, REF.ruamel_yaml = saved

    @pytest.mark.skipif(
        not os.environ.get('PROTEUS_FULL_E2E'),
        reason='full-size run (minutes); set PROTEUS_FULL_E2E=1')
    def test_full_size_core_layers(self, ref_with_shims, tmp_path):
        """Production-size (3660^2) reference-vs-ours comparison: full
        COG pyramid (overviews 4/16/64/128), partial edge tiles, big
        browse resize — everything the 720-px run cannot exercise.
        PROTEUS_FULL_E2E=2 adds the DEM/landcover ancillaries (LAND,
        SHAD, float32 DEM layer over the full 10980^2 WorldCover warp).
        PROTEUS_FULL_E2E=3 additionally runs the whole chain in
        scaled-float32 mode (flag_offset_and_scale_inputs, the
        reference's --offset-and-scale-inputs, dswx_hls.py:2298-2302) —
        the full-size gate for the exact-boundary float path."""
        level = os.environ.get('PROTEUS_FULL_E2E')
        with_anc = level in ('2', '3')
        scaled = level == '3'
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir,
                                                      size=3660)
        anc = {}
        if with_anc:
            for d in ('dem', 'lc', 'wc'):
                os.makedirs(str(tmp_path / d))
            anc = dict(
                dem_file=synthetic.make_dem(str(tmp_path / 'dem'),
                                            size=3660),
                landcover_file=synthetic.make_landcover(
                    str(tmp_path / 'lc'), size=3660),
                worldcover_file=synthetic.make_worldcover(
                    str(tmp_path / 'wc'), size=3660))
        ref_dir = str(tmp_path / 'ref_out')
        our_dir = str(tmp_path / 'our_out')
        ref_scratch = str(tmp_path / 'ref_scratch')
        our_scratch = str(tmp_path / 'our_scratch')
        for d in (ref_dir, our_dir, ref_scratch, our_scratch):
            os.makedirs(d)
        common, ref_t, our_t = _common_kwargs('dswx_e2e_full')

        def outs(out_dir):
            out = _per_layer_outputs(out_dir)
            if with_anc:
                out.update(
                    output_landcover=os.path.join(out_dir, 'land.tif'),
                    output_shadow_layer=os.path.join(out_dir,
                                                     'shad.tif'),
                    output_dem_layer=os.path.join(out_dir, 'dem.tif'))
            return out

        if scaled:
            common = dict(common, flag_offset_and_scale_inputs=True)
        ret = ref_with_shims.generate_dswx_layers(
            list(files), hls_thresholds=ref_t,
            scratch_dir=ref_scratch, **outs(ref_dir), **anc, **common)
        assert ret
        ret = orchestrator.generate_dswx_layers(
            list(files), hls_thresholds=our_t,
            scratch_dir=our_scratch, **outs(our_dir), **anc, **common)
        assert ret
        _compare_trees(ref_dir, our_dir)

    def test_reference_comparator_on_our_products(self, ref_with_shims,
                                                  tmp_path):
        """The reference's own compare_dswx_hls_products
        (dswx_hls.py:705-871) executes over our product files through
        the shim: identical files compare equal; a perturbed copy is
        detected — cross-validating runtime/compare.py's semantics."""
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir, size=360)
        out_dir = str(tmp_path / 'out')
        scratch = str(tmp_path / 'scratch')
        os.makedirs(out_dir)
        os.makedirs(scratch)
        common, _ref_t, our_t = _common_kwargs('dswx_cmp')
        wtr = os.path.join(out_dir, 'wtr.tif')
        ret = orchestrator.generate_dswx_layers(
            list(files), hls_thresholds=our_t,
            output_interpreted_band=wtr, scratch_dir=scratch, **common)
        assert ret
        assert ref_with_shims.compare_dswx_hls_products(wtr, wtr)

        from proteus_jax.io.tiff import TiffReader
        from proteus_jax.io.cog import write_cog
        with TiffReader(wtr) as r:
            arr = r.read()
            gt = r.geotransform()
            epsg = r.epsg()
            md = r.metadata()
        arr2 = arr.copy()
        arr2[7, 11] = 77
        other = os.path.join(out_dir, 'wtr_mod.tif')
        write_cog(other, arr2, geotransform=gt, epsg=epsg, metadata=md)
        assert not ref_with_shims.compare_dswx_hls_products(wtr, other)

    def test_reference_cog_validator_on_our_products(self, ref_with_shims,
                                                     tmp_path):
        """The reference's COG validator
        (extern/validate_cloud_optimized_geotiff.py) executes its FULL
        check — IFD ordering, data-offset ordering, structural ghost
        metadata, per-tile leader/trailer bytes — over our product files
        through the shim's structural TIFF queries; a product must pass
        with zero errors and a corrupted leader byte must be caught."""
        import importlib
        val = importlib.import_module(
            'proteus.extern.validate_cloud_optimized_geotiff')
        g, _, _ = gdal_shim.make_modules()
        saved = val.gdal
        val.gdal = g
        try:
            input_dir = str(tmp_path / 'input')
            files, _bands = synthetic.make_hls_v2_dataset(input_dir,
                                                          size=720)
            out_dir = str(tmp_path / 'out')
            scratch = str(tmp_path / 'scratch')
            os.makedirs(out_dir)
            os.makedirs(scratch)
            common, _rt, our_t = _common_kwargs('dswx_val')
            wtr = os.path.join(out_dir, 'wtr.tif')
            assert orchestrator.generate_dswx_layers(
                list(files), hls_thresholds=our_t,
                output_interpreted_band=wtr, scratch_dir=scratch,
                **common)
            warnings_, errors_, details = val.validate(wtr,
                                                       full_check=True)
            assert errors_ == [], errors_
            assert details['ifd_offsets']['main'] > 16

            # corrupt one tile-leader byte: the full check must fail
            first_block = int(details['data_offsets']['main'])
            bad = os.path.join(out_dir, 'wtr_bad.tif')
            with open(wtr, 'rb') as fh:
                blob = bytearray(fh.read())
            blob[first_block - 4] ^= 0xFF  # leader length word
            with open(bad, 'wb') as fh:
                fh.write(bytes(blob))
            _w, errors_bad, _d = val.validate(bad, full_check=True)
            assert any('leader' in e for e in errors_bad), errors_bad
        finally:
            val.gdal = saved

    def test_reference_mgrs_boundaries_on_our_engines(self,
                                                      ref_with_shims):
        """The reference's get_hls_geographic_boundaries_from_mgrs_tile
        (core.py:93-155) executes with the mgrs library backed by our
        MGRS math and osr by our CRS engine (authority axis order — the
        reference unpacks lat-first there), matching our implementation
        for tiles across zones/hemispheres to sub-metre precision."""
        import importlib
        import types
        core = importlib.import_module('proteus.core')
        from proteus_jax.geo.mgrs import (
            get_hls_geographic_boundaries_from_mgrs_tile as ours,
            mgrs_to_utm)

        class _MGRS:
            def MGRSToUTM(self, name):
                zone, north, x, y = mgrs_to_utm(name)
                return zone, ('N' if north else 'S'), x, y

        _, osr_mod, _ = gdal_shim.make_modules()
        saved = {'osr': core.osr,
                 'mgrs': sys.modules.get('mgrs')}
        core.osr = osr_mod
        sys.modules['mgrs'] = types.SimpleNamespace(MGRS=_MGRS)
        try:
            for tile in ('T15RYP', 'T18LVQ', '33UUP', 'T01KAB'):
                want = core.get_hls_geographic_boundaries_from_mgrs_tile(
                    tile.lstrip('T') if tile.startswith('33') else tile)
                got = ours(tile)
                np.testing.assert_allclose(got, want, atol=1e-9,
                                           err_msg=tile)
        finally:
            core.osr = saved['osr']
            if saved['mgrs'] is None:
                del sys.modules['mgrs']
            else:
                sys.modules['mgrs'] = saved['mgrs']

    def test_reference_multiband_output_quirks(self, ref_with_shims,
                                               tmp_path, monkeypatch):
        """Document the reference's single-file (``output_file``) product
        quirks, observed by executing its code: CONF is never passed to
        save_dswx_product (dswx_hls.py:5383-5397), so the product packs 9
        layers into 10 allocated bands leaving the last empty; the
        ``description`` variable latches on the first band
        (dswx_hls.py:2682-2683), labelling every band 'Water
        classification (WTR)'. Our product writer deliberately fixes
        both (COMPONENTS.md); shipped OPERA products are per-layer files,
        which match bit-for-bit (the tests above)."""
        monkeypatch.setenv('PROTEUS_HOST_WARP', '1')
        input_dir = str(tmp_path / 'input')
        files, _bands = synthetic.make_hls_v2_dataset(input_dir, size=360)
        for d in ('dem', 'lc', 'wc', 'out', 'scratch'):
            os.makedirs(str(tmp_path / d))
        anc = dict(
            dem_file=synthetic.make_dem(str(tmp_path / 'dem'), size=360),
            landcover_file=synthetic.make_landcover(
                str(tmp_path / 'lc'), size=360),
            worldcover_file=synthetic.make_worldcover(
                str(tmp_path / 'wc'), size=360))
        common, ref_t, _ = _common_kwargs('dswx_quirks')
        out = str(tmp_path / 'out' / 'dswx.tif')
        ret = ref_with_shims.generate_dswx_layers(
            list(files), output_file=out, hls_thresholds=ref_t,
            scratch_dir=str(tmp_path / 'scratch'), **anc, **common)
        assert ret
        from proteus_jax.io.tiff import TiffReader
        with TiffReader(out) as r:
            stack = r.read()
            descs = r.band_descriptions()
        assert stack.shape[2] == 10
        assert np.array_equal(np.unique(stack[:, :, 9]), [0])  # empty band
        assert all(d == 'Water classification (WTR)'
                   for d in descs.values())  # latched description
