"""LAND layer: combine CGLS Land Cover 100 m with ESA WorldCover 10 m.

Device part of the reference create_landcover_mask (dswx_hls.py:911-1130):
the inputs are already warped to the product grid (CGLS at 1x, WorldCover at
3x supersampling); here we build the water/urban/tree binary masks, 3x3
sum-decimate them (MXU-free reduce work), and combine them through the
threshold hierarchy. The WorldCover year extraction and the warps live in
the host layer (proteus_jax.runtime.orchestrator / proteus_jax.geo.warp).
"""

import jax.numpy as jnp

from proteus_jax.core import constants as C
from proteus_jax.ops.resample import decimate_by_summation


def create_landcover_mask_arrays(copernicus_landcover_array,
                                 worldcover_array_up_3,
                                 mask_type: str,
                                 forest_mask_landcover_classes,
                                 worldcover_year: int = 2000):
    """Build the LAND hierarchy from pre-warped landcover arrays.

    Parameters
    ----------
    copernicus_landcover_array : (H, W) integer array — CGLS classes on the
        product grid.
    worldcover_array_up_3 : (3H, 3W) integer array — WorldCover classes on
        the 3x supersampled product grid.
    mask_type : 'standard' | 'water heavy' — selects the threshold list
        [evergreen, low-intensity dev, high-intensity dev, water].
    forest_mask_landcover_classes : list of CGLS class ids treated as forest.
    worldcover_year : year encoded into the developed classes (year-2000).
    """
    wc = jnp.asarray(worldcover_array_up_3)

    water_mask = ((wc == C.WORLDCOVER_WATER_CLASSES[0]) |
                  (wc == C.WORLDCOVER_WATER_CLASSES[1]) |
                  (wc == C.WORLDCOVER_WATER_CLASSES[2])).astype(jnp.uint8)
    water_sum = decimate_by_summation(water_mask, 3, 3)

    urban_mask = (wc == C.WORLDCOVER_URBAN_CLASS).astype(jnp.uint8)
    urban_sum = decimate_by_summation(urban_mask, 3, 3)

    tree_mask = (wc == C.WORLDCOVER_TREE_CLASS).astype(jnp.uint8)
    tree_sum = decimate_by_summation(tree_mask, 3, 3)

    cgls = jnp.asarray(copernicus_landcover_array)
    copernicus_forest = jnp.zeros(cgls.shape, dtype=bool)
    for cls in (forest_mask_landcover_classes or ()):
        copernicus_forest = copernicus_forest | (cgls == int(cls))
    tree_sum = jnp.where(copernicus_forest, tree_sum, 0)

    thresholds = C.LANDCOVER_THRESHOLD_DICT[mask_type.lower()]
    fill = C.DSWX_HLS_LANDCOVER_CLASSES_DICT['fill_value']
    year_offset = int(worldcover_year) - 2000

    out = jnp.full(water_sum.shape, fill, dtype=jnp.uint8)
    # hierarchy (later assignments take precedence, as in the reference):
    # evergreen, low-intensity developed, high-intensity developed, water
    out = jnp.where(tree_sum >= thresholds[0],
                    jnp.uint8(C.DSWX_HLS_LANDCOVER_CLASSES_DICT[
                        'evergreen_forest']), out)
    out = jnp.where(urban_sum >= thresholds[1],
                    jnp.uint8(C.DSWX_HLS_LANDCOVER_CLASSES_DICT[
                        'low_intensity_developed_offset'] + year_offset), out)
    out = jnp.where(urban_sum >= thresholds[2],
                    jnp.uint8(C.DSWX_HLS_LANDCOVER_CLASSES_DICT[
                        'high_intensity_developed_offset'] + year_offset), out)
    out = jnp.where(water_sum >= thresholds[3],
                    jnp.uint8(C.DSWX_HLS_LANDCOVER_CLASSES_DICT['water']),
                    out)
    return out
