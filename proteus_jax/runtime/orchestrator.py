"""End-to-end DSWx-HLS product generation (the library API).

``generate_dswx_layers`` keeps the exact keyword surface of the reference
orchestrator (dswx_hls.py:4610-5417) so reference users can switch without
code changes — but the architecture is accelerator-first: the HLS bands
are staged to device once, the entire per-pixel science chain (and the DEM shadow
computation) runs as one jit-compiled XLA program
(proteus_jax.models.dswx.chain), and only file I/O, reprojection planning,
runconfig parsing, and metadata stay on host. The CLI entry points turn
on the JAX persistent compilation cache (utils/compile_cache.py), so
repeated invocations reuse the compiled chain.
"""

import logging
import os

import numpy as np

import jax
import jax.numpy as jnp

from proteus_jax.core import constants as C
from proteus_jax.core.thresholds import HlsThresholds
from proteus_jax.config.runconfig import parse_runconfig_file
from proteus_jax.io import hls as hls_io
from proteus_jax.io.png import geotiff2png
from proteus_jax.models.dswx.chain import DswxChainConfig, dswx_chain
from proteus_jax.models.dswx.landcover import create_landcover_mask_arrays
from proteus_jax.models.dswx.shadow import (compute_opera_shadow_layer_exact,
                                            compute_otsu_shadow_layer_exact)
from proteus_jax.runtime import ctables, metadata as md_util
from proteus_jax.runtime import product_writer as pw
from proteus_jax.runtime.profiling import StageTimers, device_trace
from proteus_jax.version import VERSION as SOFTWARE_VERSION

logger = logging.getLogger('dswx_hls')



def _mean_angle(meta_value):
    parts = str(meta_value).split(', ')
    if len(parts) == 2:
        return (float(parts[0]) + float(parts[1])) / 2.0
    return float(parts[0])


def _crop_margin(arr, margin):
    return arr[margin:-margin, margin:-margin]


def generate_dswx_layers(input_list,
                         output_file=None,
                         hls_thresholds=None,
                         dem_file=None,
                         dem_file_description=None,
                         output_interpreted_band=None,
                         output_rgb_file=None,
                         output_infrared_rgb_file=None,
                         output_binary_water=None,
                         output_confidence_layer=None,
                         output_diagnostic_layer=None,
                         output_non_masked_dswx=None,
                         output_shadow_masked_dswx=None,
                         output_landcover=None,
                         output_shadow_layer=None,
                         output_cloud_layer=None,
                         output_dem_layer=None,
                         output_browse_image=None,
                         browse_image_height=None,
                         browse_image_width=None,
                         exclude_psw_aggressive_in_browse=None,
                         not_water_in_browse=None,
                         cloud_in_browse=None,
                         snow_in_browse=None,
                         landcover_file=None,
                         landcover_file_description=None,
                         worldcover_file=None,
                         worldcover_file_description=None,
                         shoreline_shapefile=None,
                         shoreline_shapefile_description=None,
                         flag_offset_and_scale_inputs=False,
                         scratch_dir='.',
                         product_id=None,
                         product_version=SOFTWARE_VERSION,
                         check_ancillary_inputs_coverage=None,
                         apply_ocean_masking=None,
                         apply_aerosol_class_remapping=None,
                         aerosol_not_water_to_high_conf_water_fmask_values=None,
                         aerosol_water_moderate_conf_to_high_conf_water_fmask_values=None,
                         aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values=None,
                         aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values=None,
                         shadow_masking_algorithm=None,
                         min_slope_angle=None,
                         max_sun_local_inc_angle=None,
                         mask_adjacent_to_cloud_mode=None,
                         forest_mask_landcover_classes=None,
                         ocean_masking_shoreline_distance_km=None,
                         flag_debug=False):
    """Compute the DSWx-HLS product. Returns True on success.

    Parameters match the reference generate_dswx_layers
    (dswx_hls.py:4610-4774); any parameter left as None is filled from the
    default runconfig, as in the reference (:4776-4849).
    """
    timers = StageTimers()

    # ---- fill None parameters from the default runconfig -----------------
    params = dict(
        hls_thresholds=hls_thresholds,
        check_ancillary_inputs_coverage=check_ancillary_inputs_coverage,
        apply_ocean_masking=apply_ocean_masking,
        apply_aerosol_class_remapping=apply_aerosol_class_remapping,
        aerosol_not_water_to_high_conf_water_fmask_values=
            aerosol_not_water_to_high_conf_water_fmask_values,
        aerosol_water_moderate_conf_to_high_conf_water_fmask_values=
            aerosol_water_moderate_conf_to_high_conf_water_fmask_values,
        aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values=
            aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values,
        aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values=
            aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values,
        shadow_masking_algorithm=shadow_masking_algorithm,
        min_slope_angle=min_slope_angle,
        max_sun_local_inc_angle=max_sun_local_inc_angle,
        mask_adjacent_to_cloud_mode=mask_adjacent_to_cloud_mode,
        forest_mask_landcover_classes=forest_mask_landcover_classes,
        ocean_masking_shoreline_distance_km=
            ocean_masking_shoreline_distance_km,
        browse_image_height=browse_image_height,
        browse_image_width=browse_image_width,
        exclude_psw_aggressive_in_browse=exclude_psw_aggressive_in_browse,
        not_water_in_browse=not_water_in_browse,
        cloud_in_browse=cloud_in_browse,
        snow_in_browse=snow_in_browse,
    )
    if any(v is None for v in params.values()):
        rc = parse_runconfig_file()
        for key, value in params.items():
            if value is None:
                params[key] = getattr(rc, key)
    hls_thresholds = params.pop('hls_thresholds')
    if isinstance(hls_thresholds, dict):
        hls_thresholds = HlsThresholds.from_dict(hls_thresholds)

    if scratch_dir is None:
        scratch_dir = '.'
    if product_id is None and output_file:
        product_id = os.path.splitext(os.path.basename(output_file))[0]
    elif product_id is None:
        product_id = 'dswx_hls'

    p = params  # short alias

    if p['shadow_masking_algorithm'] not in ('otsu', 'sun_local_inc_angle'):
        msg = (f"ERROR Invalid shadow masking algorithm:"
               f" {p['shadow_masking_algorithm']}")
        logger.error(msg)
        raise ValueError(msg)

    # ---- parameter logging (reference dswx_hls.py:4864-4956) --------------
    ocean_unused = '' if p['apply_ocean_masking'] else ' (unused)'
    logger.info(f'PROTEUS-JAX software version: {SOFTWARE_VERSION}')
    logger.info('input files:')
    logger.info('    HLS product file(s):')
    for f in (input_list if isinstance(input_list, list) else [input_list]):
        logger.info(f'        {f}')
    if output_file:
        logger.info(f'    output multi-band file: {output_file}')
    logger.info(f'    DEM file: {dem_file}')
    logger.info(f'    Copernicus CGLS Land Cover 100m file:'
                f' {landcover_file}')
    logger.info(f'    ESA WorldCover 10m file: {worldcover_file}')
    logger.info(f'    NOAA shoreline shapefile: {shoreline_shapefile}'
                f'{ocean_unused}')
    logger.info('product parameters:')
    logger.info(f'    product ID: {product_id}')
    logger.info(f'    product version: {product_version}')
    logger.info('processing parameters:')
    logger.info(f'    scratch directory: {scratch_dir}')
    logger.info(f"    check ancillary coverage:"
                f" {p['check_ancillary_inputs_coverage']}")
    logger.info(f"    apply ocean masking: {p['apply_ocean_masking']}")
    logger.info(f"    apply aerosol water class remapping:"
                f" {p['apply_aerosol_class_remapping']}")
    logger.info(f"    shadow masking algorithm:"
                f" {p['shadow_masking_algorithm']}")
    logger.info(f"    mask adjacent cloud/cloud-shadow mode:"
                f" {p['mask_adjacent_to_cloud_mode']}")
    logger.info(f"    CGLS Land Cover 100m forest classes:"
                f" {p['forest_mask_landcover_classes']}")

    if not p['apply_ocean_masking']:
        shoreline_shapefile = None
        shoreline_shapefile_description = None

    os.makedirs(scratch_dir, exist_ok=True)

    # ---- ingest ------------------------------------------------------------
    hls_arrays = {}
    offset_dict = {}
    scale_dict = {}
    scratch_files = []
    standalone_output_files = []
    vrt_member_files = []
    dem = None
    shadow_layer = None

    dswx_metadata_dict = md_util.get_dswx_metadata_dict(product_id,
                                                        product_version)

    with timers.stage('ingest (HLS bands)'):
        version = None
        if not isinstance(input_list, list) or len(input_list) == 1:
            success = hls_io.load_hls_product_v1(
                input_list, hls_arrays, offset_dict, scale_dict,
                dswx_metadata_dict, flag_offset_and_scale_inputs,
                flag_debug=flag_debug)
            if success:
                version = '1.4'
        else:
            success = None
        if success is not True:
            success = hls_io.load_hls_product_v2(
                input_list, hls_arrays, offset_dict, scale_dict,
                dswx_metadata_dict, flag_offset_and_scale_inputs,
                flag_debug=flag_debug)
            if not success:
                logger.info(f'ERROR could not read file(s): {input_list}')
                return False
            version = '2.0'
    hls_dataset_name = hls_arrays['hls_dataset_name']
    md_util.populate_dswx_metadata_datasets(
        dswx_metadata_dict, hls_dataset_name,
        dem_file=dem_file, dem_file_description=dem_file_description,
        landcover_file=landcover_file,
        landcover_file_description=landcover_file_description,
        worldcover_file=worldcover_file,
        worldcover_file_description=worldcover_file_description,
        shoreline_shapefile=shoreline_shapefile,
        shoreline_shapefile_description=shoreline_shapefile_description)
    md_util.populate_dswx_metadata_processing_parameters(
        dswx_metadata_dict,
        apply_ocean_masking=p['apply_ocean_masking'],
        apply_aerosol_class_remapping=p['apply_aerosol_class_remapping'],
        aerosol_not_water_to_high_conf_water_fmask_values=
            p['aerosol_not_water_to_high_conf_water_fmask_values'],
        aerosol_water_moderate_conf_to_high_conf_water_fmask_values=
            p['aerosol_water_moderate_conf_to_high_conf_water_fmask_values'],
        aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values=
            p['aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values'],
        aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values=
            p['aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values'],
        shadow_masking_algorithm=p['shadow_masking_algorithm'],
        min_slope_angle=p['min_slope_angle'],
        max_sun_local_inc_angle=p['max_sun_local_inc_angle'],
        mask_adjacent_to_cloud_mode=p['mask_adjacent_to_cloud_mode'],
        forest_mask_landcover_classes=p['forest_mask_landcover_classes'],
        shoreline_shapefile=shoreline_shapefile,
        ocean_masking_shoreline_distance_km=
            p['ocean_masking_shoreline_distance_km'])

    spacecraft_name = dswx_metadata_dict['SPACECRAFT_NAME']
    logger.info(f'processing HLS {spacecraft_name[0]}30 dataset'
                f' v.{version}')

    blue = hls_arrays['blue']
    green = hls_arrays['green']
    red = hls_arrays['red']
    nir = hls_arrays['nir']
    swir1 = hls_arrays['swir1']
    swir2 = hls_arrays['swir2']
    fmask = hls_arrays['fmask']
    geotransform = hls_arrays['geotransform']
    projection = hls_arrays['projection']
    length = hls_arrays['length']
    width = hls_arrays['width']
    invalid_array = hls_arrays['invalid_ind_array']
    del hls_arrays

    sun_azimuth_angle = _mean_angle(
        dswx_metadata_dict['MEAN_SUN_AZIMUTH_ANGLE'])
    sun_zenith_angle = _mean_angle(
        dswx_metadata_dict['MEAN_SUN_ZENITH_ANGLE'])
    sun_elevation_angle = 90 - float(sun_zenith_angle)
    logger.info('Sun parameters (from HLS metadata):')
    logger.info(f'    mean azimuth angle: {sun_azimuth_angle}')
    logger.info(f'    mean elevation angle: {sun_elevation_angle}')

    # ---- ancillary coverage checks ----------------------------------------
    from proteus_jax.geo.coverage import check_ancillary_inputs
    with timers.stage('ancillary coverage checks'):
        check_ancillary_inputs(
            p['check_ancillary_inputs_coverage'],
            p['apply_ocean_masking'],
            dem_file, landcover_file, worldcover_file,
            shoreline_shapefile, geotransform, projection, length, width,
            dswx_metadata_dict)

    if 'INPUT_HLS_PRODUCT_SPATIAL_COVERAGE' in dswx_metadata_dict:
        logger.info(f"    input HLS product spatial coverage [%]:"
                    f" {dswx_metadata_dict['INPUT_HLS_PRODUCT_SPATIAL_COVERAGE']}")
    if 'INPUT_HLS_PRODUCT_CLOUD_COVERAGE' in dswx_metadata_dict:
        logger.info(f"    input HLS product cloud coverage [%]:"
                    f" {dswx_metadata_dict['INPUT_HLS_PRODUCT_CLOUD_COVERAGE']}")

    # ---- ocean mask (host rasterization, device buffer) ---------------------
    ocean_mask = None
    if shoreline_shapefile is not None:
        from proteus_jax.geo.polygon import create_ocean_mask
        with timers.stage('ocean mask'):
            ocean_mask = create_ocean_mask(
                shoreline_shapefile,
                p['ocean_masking_shoreline_distance_km'],
                scratch_dir, geotransform, projection, length, width,
                temp_files_list=scratch_files, as_device=True)

    # ---- DEM warp + terrain shadow (device) ---------------------------------
    use_host_warp = bool(os.environ.get('PROTEUS_HOST_WARP'))
    if dem_file is not None:
        from proteus_jax.geo.warp import warp_to_grid, warp_to_grid_device
        logger.info(f'Preparing DEM file: {dem_file}')
        with timers.stage('DEM warp'):
            if use_host_warp:
                dem_with_margin = jnp.asarray(warp_to_grid(
                    dem_file, geotransform, projection, length, width,
                    resample_algorithm='cubic',
                    margin_in_pixels=C.DEM_MARGIN_IN_PIXELS))
            else:
                dem_with_margin = warp_to_grid_device(
                    dem_file, geotransform, projection, length, width,
                    resample_algorithm='cubic',
                    margin_in_pixels=C.DEM_MARGIN_IN_PIXELS)
            dem_with_margin.block_until_ready()
        with timers.stage('terrain shadow'):
            if p['shadow_masking_algorithm'] == 'otsu':
                shadow_with_margin = compute_otsu_shadow_layer_exact(
                    dem_with_margin, sun_azimuth_angle,
                    sun_elevation_angle,
                    pixel_spacing_x=geotransform[1],
                    pixel_spacing_y=geotransform[5], as_device=True)
            else:
                shadow_with_margin = compute_opera_shadow_layer_exact(
                    dem_with_margin, sun_azimuth_angle,
                    sun_elevation_angle, p['min_slope_angle'],
                    p['max_sun_local_inc_angle'], as_device=True)
        # stay on device: the shadow feeds the device chain and both are
        # materialized only when their product layers are written
        shadow_layer = jnp.asarray(
            _crop_margin(shadow_with_margin, C.DEM_MARGIN_IN_PIXELS),
            jnp.uint8)
        dem = _crop_margin(jnp.asarray(dem_with_margin),
                           C.DEM_MARGIN_IN_PIXELS)

    # ---- landcover (host warps + device combine) ----------------------------
    landcover_mask = None
    if landcover_file is not None and worldcover_file is not None:
        from proteus_jax.geo.warp import (warp_to_grid,
                                          warp_to_grid_device,
                                          worldcover_year_of)
        with timers.stage('landcover warps + LAND'):
            _warp = warp_to_grid if use_host_warp else warp_to_grid_device
            logger.info('creating LAND layer combining Copernicus '
                        'Landcover 100m and ESA WorldCover 10m maps')
            if not os.path.isfile(landcover_file):
                logger.error(f'ERROR file not found: {landcover_file}')
            elif not os.path.isfile(worldcover_file):
                logger.error(f'ERROR file not found: {worldcover_file}')
            else:
                cgls = _warp(landcover_file, geotransform, projection,
                             length, width, resample_algorithm='nearest')
                gt3 = (geotransform[0], geotransform[1] / 3, 0.0,
                       geotransform[3], 0.0, geotransform[5] / 3)
                wc3 = _warp(worldcover_file, gt3, projection,
                            3 * length, 3 * width,
                            resample_algorithm='nearest')
                year = worldcover_year_of(worldcover_file,
                                          worldcover_file_description)
                landcover_mask = jnp.asarray(create_landcover_mask_arrays(
                    jnp.asarray(cgls), jnp.asarray(wc3),
                    C.LANDCOVER_MASK_TYPE,
                    p['forest_mask_landcover_classes'],
                    worldcover_year=year), jnp.uint8)

    # ---- the fused device chain ---------------------------------------------
    chain_config = DswxChainConfig(
        thresholds=hls_thresholds,
        mask_adjacent_to_cloud_mode=p['mask_adjacent_to_cloud_mode'],
        apply_aerosol_class_remapping=p['apply_aerosol_class_remapping'],
        aerosol_not_water_fmask_values=tuple(
            p['aerosol_not_water_to_high_conf_water_fmask_values']),
        aerosol_moderate_conf_fmask_values=tuple(
            p['aerosol_water_moderate_conf_to_high_conf_water_fmask_values']),
        aerosol_psw_conservative_fmask_values=tuple(
            p['aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values']),
        aerosol_psw_aggressive_fmask_values=tuple(
            p['aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values']),
        exclude_psw_aggressive_in_browse=bool(
            p['exclude_psw_aggressive_in_browse']),
        not_water_in_browse=p['not_water_in_browse'],
        cloud_in_browse=p['cloud_in_browse'],
        snow_in_browse=p['snow_in_browse'],
    )

    def chain_fn(b, g, r, n, s1, s2, fm, inv, ocean, shad, lc):
        return dswx_chain(b, g, r, n, s1, s2, fm, inv, chain_config,
                          ocean_mask=ocean, shadow_layer=shad,
                          landcover_mask=lc,
                          compute_browse=output_browse_image is not None)

    # optional inputs become static-None arguments of the traced closure
    optional = dict(ocean=ocean_mask, shad=shadow_layer, lc=landcover_mask)
    present = {k: v for k, v in optional.items() if v is not None}

    def chain_partial(b, g, r, n, s1, s2, fm, inv, **kw):
        full = {k: kw.get(k) for k in ('ocean', 'shad', 'lc')}
        return chain_fn(b, g, r, n, s1, s2, fm, inv, **full)

    jitted = jax.jit(chain_partial)
    logger.info('running the fused DSWx device chain'
                f" on {jax.devices()[0].platform}")
    with device_trace(os.environ.get('PROTEUS_TRACE_DIR')):
        with timers.stage('device chain (compile+run)'):
            out = jitted(jnp.asarray(blue), jnp.asarray(green),
                         jnp.asarray(red), jnp.asarray(nir),
                         jnp.asarray(swir1), jnp.asarray(swir2),
                         jnp.asarray(fmask),
                         jnp.asarray(invalid_array),
                         **{k: jnp.asarray(v) for k, v in
                            present.items()})
            out = jax.tree_util.tree_map(lambda x: x.block_until_ready(),
                                         out)
        with timers.stage('device->host transfer'):
            out = jax.device_get(out)

    # ---- coverage statistics -> metadata ------------------------------------
    total_number_of_pixels = length * width
    n_valid = int(out['n_valid'])
    n_cloud_and_valid = int(out['n_cloud_and_valid'])
    n_not_ocean = int(out['n_not_ocean'])
    spatial_coverage = int(100 * float(n_valid) / total_number_of_pixels)
    cloud_coverage = (0 if n_valid == 0
                      else int(100 * float(n_cloud_and_valid) / n_valid))
    spatial_coverage_after_ocean = (
        0 if n_not_ocean == 0
        else int(100 * float(n_valid) / n_not_ocean))
    logger.info('data coverage:')
    logger.info(f'    spatial coverage [%]:  {spatial_coverage}')
    logger.info(f'    spatial coverage after ocean masking [%]:'
                f' {spatial_coverage_after_ocean}')
    logger.info(f'    cloud coverage [%]:  {cloud_coverage}')
    dswx_metadata_dict['SPATIAL_COVERAGE'] = spatial_coverage
    dswx_metadata_dict['SPATIAL_COVERAGE_EXCLUDING_MASKED_OCEAN'] = \
        spatial_coverage_after_ocean
    dswx_metadata_dict['CLOUD_COVERAGE'] = cloud_coverage

    # ---- layer saves (reference order; dswx_hls.py:5138-5397) ---------------
    import time
    timers_saves_elapsed = [0.0]
    _saves_t0 = time.perf_counter()
    if dem is not None and output_dem_layer is not None:
        pw.save_array(dem, output_dem_layer, dswx_metadata_dict,
                      geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['DEM'],
                      output_files_list=vrt_member_files,
                      no_data_value=np.nan)
    if shadow_layer is not None and output_shadow_layer:
        pw.save_array(shadow_layer, output_shadow_layer,
                      dswx_metadata_dict, geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['SHAD'],
                      output_files_list=vrt_member_files,
                      ctable=ctables.get_binary_mask_ctable())
    if landcover_mask is not None and output_landcover:
        pw.save_array(landcover_mask, output_landcover,
                      dswx_metadata_dict, geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['LAND'],
                      output_files_list=vrt_member_files,
                      ctable=ctables.get_landcover_mask_ctable(),
                      no_data_value=C.DSWX_HLS_LANDCOVER_CLASSES_DICT[
                          'fill_value'])

    invalid_ind = np.where(invalid_array)
    if output_rgb_file:
        pw.save_output_rgb_file(red, green, blue, output_rgb_file,
                                offset_dict, scale_dict,
                                flag_offset_and_scale_inputs,
                                dswx_metadata_dict, geotransform,
                                projection, invalid_ind=invalid_ind,
                                output_files_list=standalone_output_files)
    if output_infrared_rgb_file:
        pw.save_output_rgb_file(swir1, nir, red, output_infrared_rgb_file,
                                offset_dict, scale_dict,
                                flag_offset_and_scale_inputs,
                                dswx_metadata_dict, geotransform,
                                projection, invalid_ind=invalid_ind,
                                output_files_list=standalone_output_files,
                                flag_infrared=True)

    if output_diagnostic_layer:
        pw.save_array(out['DIAG'], output_diagnostic_layer,
                      dswx_metadata_dict, geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['DIAG'],
                      output_files_list=vrt_member_files,
                      no_data_value=C.DIAGNOSTIC_LAYER_NO_DATA_BINARY_REPR)
    if output_non_masked_dswx:
        pw.save_dswx_product(out['WTR-1'], 'WTR-1', output_non_masked_dswx,
                             dswx_metadata_dict, geotransform, projection,
                             output_files_list=vrt_member_files)
    if output_shadow_masked_dswx is not None:
        pw.save_dswx_product(out['WTR-2'], 'WTR-2',
                             output_shadow_masked_dswx,
                             dswx_metadata_dict, geotransform, projection,
                             output_files_list=vrt_member_files)
    if output_interpreted_band:
        pw.save_dswx_product(out['WTR'], 'WTR', output_interpreted_band,
                             dswx_metadata_dict, geotransform, projection,
                             output_files_list=vrt_member_files)

    if output_browse_image:
        browse_ctable = ctables.get_browse_ctable(
            flag_collapse_wtr_classes=C.FLAG_COLLAPSE_WTR_CLASSES,
            not_water_color=p['not_water_in_browse'],
            cloud_color=p['cloud_in_browse'],
            snow_color=p['snow_in_browse'])
        browse_geotiff = output_browse_image.replace('.png', '.tif')
        standalone_output_files.append(browse_geotiff)
        pw.save_array(out['BROWSE'], browse_geotiff, dswx_metadata_dict,
                      geotransform, projection,
                      ctable=browse_ctable,
                      no_data_value=C.UINT8_FILL_VALUE)
        geotiff2png(browse_geotiff, output_browse_image,
                    output_height=p['browse_image_height'],
                    output_width=p['browse_image_width'],
                    logger_=logger, rgba_ctable=browse_ctable)
        standalone_output_files.append(output_browse_image)

    if output_cloud_layer:
        pw.save_cloud_layer(out['CLOUD'], output_cloud_layer,
                            dswx_metadata_dict, geotransform, projection,
                            description=C.BAND_DESCRIPTION_DICT['CLOUD'],
                            output_files_list=vrt_member_files)
    if output_binary_water:
        pw.save_binary_water(out['BWTR'], output_binary_water,
                             dswx_metadata_dict, geotransform, projection,
                             description=C.BAND_DESCRIPTION_DICT['BWTR'],
                             output_files_list=vrt_member_files)
    if output_confidence_layer:
        pw.save_array(out['CONF'], output_confidence_layer,
                      dswx_metadata_dict, geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['CONF'],
                      output_files_list=vrt_member_files,
                      ctable=ctables.get_confidence_layer_ctable(),
                      no_data_value=C.UINT8_FILL_VALUE)

    if output_file and not output_file.endswith('.vrt'):
        pw.save_dswx_product(out['WTR'], 'WTR', output_file,
                             dswx_metadata_dict, geotransform, projection,
                             bwtr=out['BWTR'], diag=out['DIAG'],
                             wtr_1=out['WTR-1'], wtr_2=out['WTR-2'],
                             land=landcover_mask, shad=shadow_layer,
                             cloud=out['CLOUD'], dem=dem,
                             output_files_list=standalone_output_files)
    elif output_file:
        from proteus_jax.io.vrt import build_vrt
        build_vrt(output_file, vrt_member_files)
        vrt_member_files.append(output_file)
        logger.info(f'file saved: {output_file}')

    timers_saves_elapsed[0] = time.perf_counter() - _saves_t0
    logger.info('removing temporary files:')
    for filename in scratch_files:
        if os.path.isfile(filename):
            os.remove(filename)
            logger.info(f'    {filename}')
    timers.add('layer saves (COG encode)',
               timers_saves_elapsed[0])
    logger.info('output files:')
    for filename in vrt_member_files + standalone_output_files:
        logger.info(f'    {filename}')
    timers.report()
    return True
