"""DSWx-HLS product writers: per-layer COGs and the combined product.

Matches the reference save family (save_dswx_product/_save_array/
save_cloud_layer/_save_binary_water/_save_output_rgb_file at
dswx_hls.py:2601-3055) — but writes cloud-optimized GeoTIFFs in a single
pass instead of the write-then-rewrite GDAL flow, and validates the COG
structure on write (reference core.py:76-90).
"""

import logging
import os

import numpy as np

from proteus_jax.core import constants as C
from proteus_jax.geo.crs import CRS
from proteus_jax.io.cog import write_cog
from proteus_jax.io.validate_cog import validate_cog
from proteus_jax.runtime import ctables

logger = logging.getLogger('dswx_hls')


def _makedirs(output_file):
    d = os.path.dirname(output_file)
    if d:
        os.makedirs(d, exist_ok=True)


def _epsg(projection):
    if projection in (None, ''):
        return None
    return CRS.from_any(projection).epsg


def _str_metadata(md):
    return {k: str(v) for k, v in (md or {}).items()}


def _finish(output_file, output_files_list):
    # write-time validation effort: 'full' re-decompresses every tile
    # (reference behavior: --full-check=yes), 'fast' checks structure
    # only, 'off' skips
    mode = os.environ.get('PROTEUS_COG_VALIDATE', 'full').lower()
    if mode == 'off':
        if output_files_list is not None:
            output_files_list.append(output_file)
        logger.info(f'file saved: {output_file}')
        return
    errors = validate_cog(output_file, full_check=(mode != 'fast'))
    if errors:
        logger.warning(f'    file "{output_file}" is NOT a valid cloud'
                       f' optimized GeoTIFF! ({errors[0]})')
    else:
        logger.info(f'    file "{output_file}" is a valid cloud optimized'
                    ' GeoTIFF')
    if output_files_list is not None:
        output_files_list.append(output_file)
    logger.info(f'file saved: {output_file}')


def collapse_wtr_classes_host(layer):
    """Host-side WTR class collapse (uint8 LUT; native when built)."""
    from proteus_jax import native
    lut = C.build_collapse_lut()
    layer = np.asarray(layer)
    if layer.dtype == np.uint8:
        out = native.lut8(layer, lut)
        if out is not None:
            return out
    return lut[layer]


def save_array(input_array, output_file, dswx_metadata_dict, geotransform,
               projection, description=None, scratch_dir='.',
               output_files_list=None, ctable=None, no_data_value=None,
               payload_key=None):
    """Save one generic DSWx-HLS layer as a COG.

    payload_key: optional pixel-payload identity key forwarded to
    write_cog's payload cache (campaign DEM layers are identical per
    grid; only the metadata tags differ between products)."""
    del scratch_dir  # single-pass writer needs no scratch space
    _makedirs(output_file)
    arr = np.asarray(input_array)
    band_desc = {0: description} if description else None
    write_cog(output_file, arr,
              geotransform=geotransform, epsg=_epsg(projection),
              nodata=no_data_value,
              metadata=_str_metadata(dswx_metadata_dict),
              band_descriptions=band_desc,
              color_map=ctables.to_rgb_map(ctable) if ctable else None,
              payload_key=payload_key)
    _finish(output_file, output_files_list)


def save_dswx_product(layer_image, layer_name, output_file,
                      dswx_metadata_dict, geotransform, projection,
                      scratch_dir='.', output_files_list=None,
                      description=None,
                      flag_collapse_wtr_classes=C.FLAG_COLLAPSE_WTR_CLASSES,
                      **dswx_processed_bands):
    """Save an interpreted layer (single band) or the full multi-band
    product, collapsing WTR classes on save."""
    del scratch_dir
    _makedirs(output_file)
    dswx_processed_bands[layer_name.replace('-', '_').lower()] = layer_image

    available = {}
    for key, arr in dswx_processed_bands.items():
        name = key.upper().replace('_', '-')
        if name in C.BAND_DESCRIPTION_DICT and arr is not None:
            available[name] = np.asarray(arr)

    if len(available) == 1:
        name, arr = next(iter(available.items()))
        if name in C.COLLAPSABLE_LAYERS_LIST and flag_collapse_wtr_classes:
            arr = collapse_wtr_classes_host(arr)
        ctable = ctables.get_interpreted_dswx_ctable(
            flag_collapse_wtr_classes, layer_name=name)
        save_array(arr, output_file, dswx_metadata_dict, geotransform,
                   projection,
                   description=description or C.BAND_DESCRIPTION_DICT[name],
                   output_files_list=output_files_list,
                   ctable=ctable, no_data_value=C.UINT8_FILL_VALUE)
        return

    # combined multi-band product: every band as uint8 in canonical order
    # (the reference creates all bands GDT_Byte; dswx_hls.py:2666)
    planes = []
    band_descriptions = {}
    for i, (name, desc) in enumerate(C.BAND_DESCRIPTION_DICT.items()):
        arr = available.get(name)
        if arr is None:
            arr = np.full(layer_image.shape, C.UINT8_FILL_VALUE, np.uint8)
        if name in C.COLLAPSABLE_LAYERS_LIST and flag_collapse_wtr_classes:
            arr = collapse_wtr_classes_host(arr)
        if arr.dtype != np.uint8:
            arr = np.clip(np.nan_to_num(
                arr.astype(np.float64), nan=0.0), 0, 255).astype(np.uint8)
        planes.append(arr)
        band_descriptions[i] = desc
    stack = np.stack(planes, axis=-1)
    write_cog(output_file, stack, geotransform=geotransform,
              epsg=_epsg(projection), nodata=C.UINT8_FILL_VALUE,
              metadata=_str_metadata(dswx_metadata_dict),
              band_descriptions=band_descriptions)
    _finish(output_file, output_files_list)


def save_cloud_layer(mask, output_file, dswx_metadata_dict, geotransform,
                     projection, description=None, scratch_dir='.',
                     output_files_list=None):
    save_array(mask, output_file, dswx_metadata_dict, geotransform,
               projection, description=description,
               output_files_list=output_files_list,
               ctable=ctables.get_cloud_layer_ctable(),
               no_data_value=C.UINT8_FILL_VALUE)


def save_binary_water(binary_water_layer, output_file, dswx_metadata_dict,
                      geotransform, projection, description=None,
                      scratch_dir='.', output_files_list=None):
    save_array(binary_water_layer, output_file, dswx_metadata_dict,
               geotransform, projection, description=description,
               output_files_list=output_files_list,
               ctable=ctables.get_binary_water_ctable(),
               no_data_value=C.UINT8_FILL_VALUE)


def save_output_rgb_file(red, green, blue, output_file, offset_dict,
                         scale_dict, flag_offset_and_scale_inputs,
                         dswx_metadata_dict, geotransform, projection,
                         invalid_ind=None, scratch_dir='.',
                         output_files_list=None, flag_infrared=False):
    """Save a 3-band float32 reflectance composition (RGB or infrared)."""
    del scratch_dir
    _makedirs(output_file)
    if not flag_offset_and_scale_inputs:
        if not flag_infrared:
            keys = ('red', 'green', 'blue')
        else:
            keys = ('swir1', 'nir', 'red')
        red = scale_dict[keys[0]] * (np.asarray(red, np.float32)
                                     - offset_dict[keys[0]])
        green = scale_dict[keys[1]] * (np.asarray(green, np.float32)
                                       - offset_dict[keys[1]])
        blue = scale_dict[keys[2]] * (np.asarray(blue, np.float32)
                                      - offset_dict[keys[2]])
    else:
        red = np.asarray(red, np.float32).copy()
        green = np.asarray(green, np.float32).copy()
        blue = np.asarray(blue, np.float32).copy()
    if invalid_ind is not None:
        for band in (red, green, blue):
            band[invalid_ind] = np.nan
    stack = np.stack([red, green, blue], axis=-1)
    write_cog(output_file, stack, geotransform=geotransform,
              epsg=_epsg(projection),
              metadata=_str_metadata(dswx_metadata_dict))
    _finish(output_file, output_files_list)
