"""Browse-image array generation (device).

Matches reference _compute_browse_array (dswx_hls.py:3057-3129): the WTR
layer with optional PSW-aggressive exclusion, optional class collapse, and
per-class nodata substitutions.
"""

import jax.numpy as jnp

from proteus_jax.core import constants as C
from proteus_jax.models.dswx.interpretation import collapse_wtr_classes


def compute_browse_array(masked_interpreted_water_layer,
                         flag_collapse_wtr_classes=C.FLAG_COLLAPSE_WTR_CLASSES,
                         exclude_psw_aggressive=False,
                         set_not_water_to_nodata=False,
                         set_cloud_to_nodata=False,
                         set_snow_to_nodata=False,
                         set_ocean_masked_to_nodata=True):
    fill = jnp.uint8(C.UINT8_FILL_VALUE)
    arr = masked_interpreted_water_layer

    if exclude_psw_aggressive:
        arr = jnp.where(
            arr == C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR,
            jnp.uint8(C.WATER_NOT_WATER_CLEAR), arr)

    if flag_collapse_wtr_classes:
        arr = collapse_wtr_classes(arr)

    if set_not_water_to_nodata:
        arr = jnp.where(arr == C.WATER_NOT_WATER_CLEAR, fill, arr)
    if set_cloud_to_nodata:
        arr = jnp.where(arr == C.WTR_CLOUD_MASKED, fill, arr)
    if set_snow_to_nodata:
        arr = jnp.where(arr == C.WTR_SNOW_MASKED, fill, arr)
    if set_ocean_masked_to_nodata:
        arr = jnp.where(arr == C.WTR_OCEAN_MASKED, fill, arr)
    return arr
