"""Ancillary-input existence and coverage checks.

Mirrors the reference _check_ancillary_inputs (dswx_hls.py:4340-4607):
verify the DEM / CGLS landcover / WorldCover rasters exist and fully cover
the product tile (with latitude-band exemptions for the landcover inputs
and a two-sided containment test across the antimeridian), record the
coverage state in the product metadata, and raise on hard failures. All
geometry is axis-aligned-rectangle arithmetic in the ancillary file's CRS,
computed with our own transform engine instead of OGR polygons.
"""

import logging
import os

import numpy as np

from proteus_jax.core.constants import (
    ANTIMERIDIAN_CROSSING_RIGHT_SIDE_TEST_BUFFER,
    LANDCOVER_LAT_MAX, LANDCOVER_LAT_MIN,
    WORLDCOVER_LAT_MAX, WORLDCOVER_LAT_MIN)
from proteus_jax.geo.crs import CRS, transform_points
from proteus_jax.io.tiff import TiffReader

logger = logging.getLogger('dswx_hls')


def tile_bbox_in_crs(geotransform, length, width, tile_crs, dst_crs):
    """Tile bounding box transformed to ``dst_crs``.

    Returns (min_y, max_y, min_x, max_x) with the antimeridian
    normalization of the reference (_get_tile_srs_bbox,
    dswx_hls.py:3385-3461): when the transformed corners straddle +/-180,
    the interval becomes [max_x, min_x + 360].
    """
    x0, dx, _, y0, _, dy = geotransform
    xmax = x0 + width * dx
    ymin = y0 + length * dy
    cx = np.array([x0, xmax, xmax, x0], dtype=np.float64)
    cy = np.array([y0, y0, ymin, ymin], dtype=np.float64)
    tx, ty = transform_points(tile_crs, dst_crs, cx, cy)
    min_x, max_x = tx.min(), tx.max()
    min_y, max_y = ty.min(), ty.max()
    if max_x > min_x + 340:
        min_x, max_x = max_x, min_x + 360
    return min_y, max_y, min_x, max_x


def antimeridian_crossing_requires_special_handling(
        file_crs, file_min_x, tile_min_x, tile_max_x):
    """Reference predicate (dswx_hls.py:3150-3190): the tile interval
    crosses +180 and the geographic ancillary uses [-180, 180] longitudes
    (detected by min_x < -170)."""
    crosses = tile_min_x < 180 and tile_max_x >= 180
    input_is_m180_180 = file_crs.is_geographic and file_min_x < -170
    return crosses and input_is_m180_180


def _rect_within(inner, outer):
    """inner/outer: (min_x, min_y, max_x, max_y)."""
    return (inner[0] >= outer[0] and inner[1] >= outer[1]
            and inner[2] <= outer[2] and inner[3] <= outer[3])


def _rect_intersection(a, b):
    return (max(a[0], b[0]), max(a[1], b[1]),
            min(a[2], b[2]), min(a[3], b[3]))


def _rect_empty(r):
    return r[0] >= r[2] or r[1] >= r[3]


def check_ancillary_inputs(check_ancillary_inputs_coverage,
                           check_shoreline_shapefile,
                           dem_file, landcover_file, worldcover_file,
                           shoreline_shapefile, geotransform, projection,
                           length, width, dswx_metadata_dict):
    """Check existence + coverage; update metadata; raise on error."""
    logger.info("check ancillary inputs' coverage:")

    descriptions = {
        'DEM': 'DEM file',
        'LANDCOVER': 'Copernicus CGLS Land Cover 100m file',
        'WORLDCOVER': 'ESA WorldCover 10m file',
        'SHORELINE_SHAPEFILE': 'NOAA shoreline shapefile',
    }

    if not check_ancillary_inputs_coverage:
        for key in ('DEM', 'LANDCOVER', 'WORLDCOVER'):
            logger.info(f'    {descriptions[key]} coverage: (not tested)')
            dswx_metadata_dict[f'{key}_COVERAGE'] = 'NOT_TESTED'
        if not check_shoreline_shapefile:
            return

    to_check = {}
    if check_ancillary_inputs_coverage:
        to_check['DEM'] = dem_file
        to_check['LANDCOVER'] = landcover_file
        to_check['WORLDCOVER'] = worldcover_file
    if check_shoreline_shapefile:
        to_check['SHORELINE_SHAPEFILE'] = shoreline_shapefile

    tile_crs = CRS.from_any(projection)

    for file_type, file_name in to_check.items():
        desc = descriptions[file_type]
        if not file_name:
            msg = f'ERROR {desc} not provided'
            logger.error(msg)
            raise ValueError(msg)
        if not os.path.isfile(file_name):
            msg = f'ERROR {desc} not found: {file_name}'
            logger.error(msg)
            raise FileNotFoundError(msg)
        if file_type == 'SHORELINE_SHAPEFILE':
            continue

        with TiffReader(file_name) as r:
            f_gt = r.geotransform()
            try:
                file_crs = r.crs() or CRS.from_epsg(4326)
            except ValueError as exc:
                # user-defined geokeys outside the supported projection
                # families -> same coverage-check-time error contract
                msg = (f'ERROR {desc} has an unsupported user-defined'
                       f' CRS ({exc}). File: {file_name}')
                logger.error(msg)
                raise ValueError(msg) from exc
            f_w, f_l = r.width, r.length
        if not file_crs.supported:
            # fail here — the reference's error contract puts ancillary
            # input problems in this check (dswx_hls.py:4428-4436) — not
            # deep inside the warp service mid-product
            msg = (f'ERROR {desc} has an unsupported CRS'
                   f' (EPSG:{file_crs.epsg}): supported CRS are WGS84'
                   ' geographic (EPSG:4326), WGS84 UTM (EPSG:326xx/'
                   '327xx), NAD83/ETRS89 geographic+UTM (EPSG:4269/'
                   '4258, 269xx/258xx), classical-datum grids with'
                   ' their Helmert shifts (OSGB36 EPSG:27700/4277,'
                   ' ED50 UTM EPSG:230xx/4230, NAD27 UTM EPSG:267xx/'
                   '4267, Tokyo EPSG:4301, Pulkovo 1942 Gauss-Krueger'
                   ' EPSG:284xx, CH1903 EPSG:21781/2056), WGS84 polar'
                   ' stereographic (EPSG:3031/3032/3413/3976), UPS'
                   ' (EPSG:5041/5042), Albers equal-area (EPSG:5070/'
                   '3577), LAEA (EPSG:3035/6931/6932), Lambert'
                   ' conformal conic (EPSG:3978/2154), Mercator'
                   ' (EPSG:3857/3395), and user-defined CRS in any of'
                   ' those projection families (TOWGS84 honored).'
                   f' File: {file_name}')
            logger.error(msg)
            raise ValueError(msg)
        min_x, f_dx, _, max_y, _, f_dy = f_gt
        max_x = min_x + f_w * f_dx
        min_y = max_y + f_l * f_dy

        tile_min_y, tile_max_y, tile_min_x, tile_max_x = tile_bbox_in_crs(
            geotransform, length, width, tile_crs, file_crs)

        tile_rect = (tile_min_x, tile_min_y, tile_max_x, tile_max_y)
        file_rect = (min_x, min_y, max_x, max_y)
        coverage_str = f'{desc} coverage'
        meta_key = f'{file_type}_COVERAGE'

        if _rect_within(tile_rect, file_rect):
            logger.info(f'    {coverage_str}: Full')
            dswx_metadata_dict[meta_key] = 'FULL'
            continue

        flag_error = False
        if antimeridian_crossing_requires_special_handling(
                file_crs, min_x, tile_min_x, tile_max_x):
            logger.info('The input HLS product crosses the antimeridian'
                        f' (dateline). Verifying the {desc}: {file_name}')
            # left side: -180 .. +180
            left = _rect_intersection(tile_rect, (-180, -90, max_x, 90))
            ok_1 = _rect_empty(left) or _rect_within(left, file_rect)
            logger.info(f"    left side (-180 -> +180):"
                        f" {'ok' if ok_1 else 'fail'}")
            # right side: +180 .. +360 (file box shifted +360)
            right = _rect_intersection(
                tile_rect,
                (max_x + ANTIMERIDIAN_CROSSING_RIGHT_SIDE_TEST_BUFFER,
                 -90, max_x + 360, 90))
            shifted = (min_x + 360, min_y, max_x + 360, max_y)
            ok_2 = _rect_empty(right) or _rect_within(right, shifted)
            logger.info(f"    right side (+180 -> +360):"
                        f" {'ok' if ok_2 else 'fail'}")
            if ok_1 and ok_2:
                logger.info(f'    {coverage_str}:'
                            ' Full (with antimeridian crossing')
                dswx_metadata_dict[meta_key] = \
                    'FULL_WITH_ANTIMERIDIAN_CROSSING'
                continue
            flag_error = True

        test_margin_degrees = 5.0 / 3600  # ~150 m

        if flag_error:
            pass
        elif file_type == 'LANDCOVER' and (tile_min_y > LANDCOVER_LAT_MAX
                                           or tile_max_y <
                                           LANDCOVER_LAT_MIN):
            logger.info(f'    {coverage_str}: None')
            dswx_metadata_dict[meta_key] = 'NONE'
        elif file_type == 'WORLDCOVER' and (tile_min_y > WORLDCOVER_LAT_MAX
                                            or tile_max_y <
                                            WORLDCOVER_LAT_MIN):
            logger.info(f'    {coverage_str}: None')
            dswx_metadata_dict[meta_key] = 'NONE'
        elif (file_type == 'LANDCOVER' and
              ((tile_max_y >= LANDCOVER_LAT_MAX and
                max_y > LANDCOVER_LAT_MAX - test_margin_degrees) or
               (tile_min_y <= LANDCOVER_LAT_MIN and
                min_y < LANDCOVER_LAT_MIN + test_margin_degrees))):
            logger.info(f'    {coverage_str}: Partial')
            dswx_metadata_dict[meta_key] = 'PARTIAL'
        elif (file_type == 'WORLDCOVER' and
              ((tile_max_y >= WORLDCOVER_LAT_MAX and
                max_y > WORLDCOVER_LAT_MAX - test_margin_degrees) or
               (tile_min_y <= WORLDCOVER_LAT_MIN and
                min_y < WORLDCOVER_LAT_MIN + test_margin_degrees))):
            logger.info(f'    {coverage_str}: Partial')
            dswx_metadata_dict[meta_key] = 'PARTIAL'
        else:
            flag_error = True

        message_type = 'ERROR' if flag_error else 'WARNING'
        msg = (f'{message_type} the {desc} with extents'
               f' S/N: [{min_y},{max_y}]'
               f' W/E: [{min_x},{max_x}],'
               ' does not fully cover input tile with'
               f' extents S/N: [{tile_min_y},{tile_max_y}]'
               f' W/E: [{tile_min_x},{tile_max_x}]')
        if flag_error:
            logger.error(msg)
            raise ValueError(msg)
        logger.warning(msg)
