"""HLS product ingest: v2 per-band GeoTIFFs and v1 HDF4-EOS datasets.

Mirrors the reference ingest layer (dswx_hls.py:2136-2425): per-band reads
with a cumulative invalid-pixel mask (fill value from the band's nodata tag,
its _FillValue metadata, or -9999), HLS metadata harvesting with
Landsat/Sentinel sensor detection, optional negative-reflectance clipping,
and optional offset+scale to float32. Debug mode reads only a 1000x1000
window.

HLS v1 products are HDF4-EOS files; proteus_jax.io.hdf4 provides the
subdataset reader for them.
"""

import logging
import os

import numpy as np

from proteus_jax.core import constants as C
from proteus_jax.io.tiff import TiffReader

logger = logging.getLogger('dswx_hls')

DEBUG_WINDOW = (0, 0, 1000, 1000)


def _harvest_metadata(metadata, dswx_metadata_dict):
    """Copy HLS metadata fields and detect the platform/sensor.

    Returns False if the platform cannot be determined or is unsupported.
    """
    for k, v in metadata.items():
        ku = k.upper()
        if ku in C.METADATA_FIELDS_TO_COPY_FROM_HLS_LIST:
            dswx_metadata_dict[ku] = v
        elif ku in ('SPATIAL_COVERAGE', 'CLOUD_COVERAGE'):
            dswx_metadata_dict['INPUT_HLS_PRODUCT_' + ku] = v
        elif ku in ('LANDSAT_PRODUCT_ID', 'PRODUCT_URI'):
            dswx_metadata_dict['SENSOR_PRODUCT_ID'] = v
        elif ku == 'SENSING_TIME':
            dswx_metadata_dict['SENSING_TIME'] = v

    sensor = None
    if 'SPACECRAFT_NAME' in metadata:
        spacecraft_name = metadata['SPACECRAFT_NAME']
        if ('SENTINEL' not in spacecraft_name.upper()
                and 'LANDSAT' not in spacecraft_name.upper()):
            logger.info(f'ERROR the platform "{spacecraft_name}" is not '
                        'supported')
            return False
    elif 'SENSOR' in metadata:
        sensor = metadata['SENSOR']
        sensor_product_id = dswx_metadata_dict.get('SENSOR_PRODUCT_ID', '')
        if 'OLI' in sensor and 'LC' in sensor_product_id:
            idx = sensor_product_id.find('LC')
            sat_num = int(sensor_product_id[idx + 2:idx + 4])
            spacecraft_name = f'Landsat-{sat_num}'
        else:
            logger.info(f'ERROR the sensor "{sensor}" is not supported')
            return False
    else:
        logger.info('ERROR could not determine the platform from metadata')
        return False

    dswx_metadata_dict['SPACECRAFT_NAME'] = spacecraft_name
    if sensor is not None:
        # e.g. "OLI_TIRS; OLI_TIRS" -> "OLI" (TIR bands unused)
        names = sensor.replace('_TIRS', '')
        parts = [s.strip() for s in names.split(';')]
        dswx_metadata_dict['SENSOR'] = '; '.join(dict.fromkeys(parts))
    elif 'SENTINEL' in spacecraft_name.upper():
        dswx_metadata_dict['SENSOR'] = 'MSI'
    else:
        dswx_metadata_dict['SENSOR'] = 'OLI'
    return True


def load_hls_band(filename, image_dict, offset_dict, scale_dict,
                  dswx_metadata_dict, band_name,
                  flag_offset_and_scale_inputs, flag_debug=False,
                  band_suffix=None, reader_factory=None):
    """Load one HLS band into image_dict; returns True/False/None."""
    factory = reader_factory or _open_raster
    try:
        raster = factory(filename)
    except (FileNotFoundError, ValueError, OSError):
        return None
    with raster as r:
        fill_value = r.nodata()
        metadata = r.metadata()

        if 'hls_dataset_name' not in image_dict:
            name = os.path.splitext(os.path.basename(str(filename)))[0]
            if band_suffix:
                name = name.replace(f'.{band_suffix}', '')
            image_dict['hls_dataset_name'] = name

        if flag_debug:
            logger.info('reading in debug mode')
            image = r.read(window=DEBUG_WINDOW)
        else:
            image = r.read()

        if fill_value is None and '_FillValue' in metadata:
            fill_value = float(metadata['_FillValue'])
        elif fill_value is None:
            fill_value = -9999

        geotransform = r.geotransform()

        # raw-Sentinel-2 ingest: bands distributed on 10 m / 20 m grids are
        # area-resampled to the 30 m product grid (BASELINE.json config 2;
        # HLS v1/v2 products are always 30 m, so this never triggers for
        # them). A 30 m pixel with any fill contributor stays fill.
        src_res = abs(geotransform[1]) if geotransform is not None else 30.0
        if band_name != 'fmask' and src_res in (10.0, 20.0):
            from proteus_jax.ops.resample import resample_to_30m
            native_invalid = image == fill_value
            mean = np.asarray(resample_to_30m(
                np.where(native_invalid, 0, image), int(src_res)))
            fill_frac = np.asarray(resample_to_30m(
                native_invalid.astype(np.float32), int(src_res)))
            image = np.rint(mean).astype(image.dtype)
            image[fill_frac > 0] = image.dtype.type(fill_value)
            sx = 1.0 if geotransform[1] > 0 else -1.0
            sy = 1.0 if geotransform[5] > 0 else -1.0
            geotransform = (geotransform[0], 30.0 * sx, geotransform[2],
                            geotransform[3], geotransform[4], 30.0 * sy)

        # fused native path: fill-mask accumulate (+ the negative clip
        # for reflectance bands) in ONE pass over the band instead of
        # three full NumPy sweeps (same per-element semantics: the fill
        # test reads the pre-clip value). Reference: fill-mask at
        # dswx_hls.py:2201-2209, clip at :2298.
        from proteus_jax import native as _native
        clip_fused = (C.FLAG_CLIP_NEGATIVE_REFLECTANCE
                      and band_name != 'fmask')
        fused = (image.dtype == np.int16 and _native.has_band_finalize()
                 and float(fill_value).is_integer()
                 and np.iinfo(np.int16).min <= fill_value
                 <= np.iinfo(np.int16).max)
        if fused:
            invalid = image_dict.get('invalid_ind_array')
            if invalid is None or invalid.dtype != np.bool_ \
                    or invalid.shape != image.shape \
                    or not invalid.flags.c_contiguous:
                base = invalid
                invalid = np.zeros(image.shape, np.bool_)
                if base is not None:
                    # mismatched granule shapes raise here (broadcast
                    # error), same as the np.logical_or path below
                    invalid |= base
            image = np.ascontiguousarray(image)
            _native.band_finalize_i16(image, int(fill_value),
                                      clip_fused, invalid)
        else:
            invalid = image == fill_value
            if 'invalid_ind_array' in image_dict:
                invalid = np.logical_or(image_dict['invalid_ind_array'],
                                        invalid)
        image_dict['invalid_ind_array'] = invalid

        image_dict.setdefault('geotransform', geotransform)
        image_dict.setdefault('projection', r.projection())
        image_dict.setdefault('length', image.shape[0])
        image_dict.setdefault('width', image.shape[1])

        if band_name == 'fmask':
            image_dict[band_name] = image
            return True

        offset = 0.0
        scale_factor = 1.0
        if 'SPACECRAFT_NAME' not in dswx_metadata_dict:
            if not _harvest_metadata(metadata, dswx_metadata_dict):
                return False
        if 'add_offset' in metadata:
            offset = float(metadata['add_offset'])
        if 'scale_factor' in metadata:
            scale_factor = float(metadata['scale_factor'])

        if C.FLAG_CLIP_NEGATIVE_REFLECTANCE and not fused:
            image = np.clip(image, 1, None)
        if flag_offset_and_scale_inputs:
            image = scale_factor * (np.asarray(image, dtype=np.float32)
                                    - offset)

        image_dict[band_name] = image
        offset_dict[band_name] = offset
        scale_dict[band_name] = scale_factor
    return True


class _TiffRaster:
    """Adapter presenting TiffReader with the raster interface the ingest
    layer needs (read/nodata/metadata/geotransform/projection)."""

    def __init__(self, filename):
        self._r = TiffReader(filename)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._r.close()

    def read(self, window=None):
        return self._r.read(window=window)

    def nodata(self):
        return self._r.nodata()

    def metadata(self):
        return self._r.metadata()

    def geotransform(self):
        return self._r.geotransform()

    def projection(self):
        from proteus_jax.geo.crs import CRS
        epsg = self._r.epsg()
        return CRS.from_epsg(epsg).to_wkt() if epsg else ''


def _open_raster(filename):
    return _TiffRaster(filename)


def load_hls_product_v2(file_list, image_dict, offset_dict, scale_dict,
                        dswx_metadata_dict, flag_offset_and_scale_inputs,
                        flag_debug=False):
    """Load an HLS v2 product from a list of per-band GeoTIFFs."""
    logger.info('loading HLS v.2.0 layers:')
    for key in C.HLS_BAND_KEYS:
        logger.info(f'    {key}')
        if ('SPACECRAFT_NAME' not in dswx_metadata_dict
                or 'LANDSAT' in
                dswx_metadata_dict['SPACECRAFT_NAME'].upper()):
            band_name = C.L30_V2_BAND_DICT[key]
        else:
            band_name = C.S30_V2_BAND_DICT[key]
        for filename in file_list:
            if band_name + '.tif' in filename:
                break
        else:
            logger.info(f'ERROR band {key} not found within list of input '
                        'file(s)')
            return None
        ok = load_hls_band(filename, image_dict, offset_dict, scale_dict,
                           dswx_metadata_dict, key,
                           flag_offset_and_scale_inputs,
                           flag_debug=flag_debug, band_suffix=band_name)
        if not ok:
            return False
    return True


def load_hls_product_v1(filename, image_dict, offset_dict, scale_dict,
                        dswx_metadata_dict, flag_offset_and_scale_inputs,
                        flag_debug=False):
    """Load an HLS v1 product (single HDF4-EOS file with band
    subdatasets)."""
    if isinstance(filename, list):
        filename = filename[0]
    from proteus_jax.io import hdf4
    if not hdf4.is_hdf4(filename):
        return None
    logger.info('loading HLS v.1.x layers:')
    for key in C.HLS_BAND_KEYS:
        logger.info(f'    {key}')
        if ('SPACECRAFT_NAME' not in dswx_metadata_dict
                or 'LANDSAT' in
                dswx_metadata_dict['SPACECRAFT_NAME'].upper()):
            band_name = C.L30_V1_BAND_DICT[key]
        else:
            band_name = C.S30_V1_BAND_DICT[key]
        ok = load_hls_band(
            filename, image_dict, offset_dict, scale_dict,
            dswx_metadata_dict, key, flag_offset_and_scale_inputs,
            flag_debug=flag_debug,
            reader_factory=lambda f: hdf4.Hdf4Raster(f, band_name))
        if not ok:
            return ok
    return True
