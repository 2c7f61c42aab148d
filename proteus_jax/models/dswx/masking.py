"""Aerosol, landcover, shadow, and cloud masking of the interpreted layer.

Reference behaviors matched:
  - _apply_aerosol_class_remapping(_single_class)   dswx_hls.py:1210-1302
  - _apply_landcover_and_shadow_masks               dswx_hls.py:1305-1378
  - _is_landcover_class_*                           dswx_hls.py:1133-1207
  - _compute_preliminary_cloud_layer                dswx_hls.py:1919-1993
  - _add_snow_to_cloud_layer                        dswx_hls.py:1996-2086
  - _apply_cloud_masking                            dswx_hls.py:2089-2133

All stages are elementwise selects plus (in 'cover' mode) two short masked
binary dilations; they fuse with the rest of the WTR chain under jit.
"""

import jax.numpy as jnp
import numpy as np

from proteus_jax.core import constants as C
from proteus_jax.core.f32exact import int_gt_bound
from proteus_jax.core.thresholds import (HlsThresholds, to_exact_fraction,
                                         SCALAR_MAX_DEN, SCALAR_MAX_NUM)
from proteus_jax.ops.morphology import binary_dilation_masked


def build_aerosol_fmask_lut(
        not_water_values, moderate_conf_values,
        psw_conservative_values, psw_aggressive_values):
    """Pack the four aerosol fmask-value lists into one 256-entry bitmask LUT.

    bit k of lut[fmask] says "fmask value triggers remap of class list k",
    where k indexes [not-water, moderate-conf, psw-conservative,
    psw-aggressive].
    """
    lut = np.zeros(256, dtype=np.uint8)
    for bit, values in enumerate([not_water_values or (),
                                  moderate_conf_values or (),
                                  psw_conservative_values or (),
                                  psw_aggressive_values or ()]):
        for v in values:
            lut[int(v)] |= (1 << bit)
    return lut


# WTR-1 classes evaluated for aerosol remapping, in reference iteration
# order; all remap to high-confidence water (dswx_hls.py:1283-1296)
_AEROSOL_INPUT_CLASSES = (
    C.WATER_NOT_WATER_CLEAR,
    C.WATER_UNCOLLAPSED_MODERATE_CONF_CLEAR,
    C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLEAR,
    C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR,
)


def apply_aerosol_class_remapping(wtr_1_layer, nir, cloud_layer, fmask,
                                  aerosol_lut):
    """Remap classes to high-confidence water under high aerosol.

    For each (input class, fmask-value list) pair: where fmask is in the
    list, WTR-1 equals the input class, and NIR <= 1000 (0.1 unscaled), the
    class becomes high-confidence water and CLOUD bit 3 is set.

    ``aerosol_lut`` is the packed LUT from build_aerosol_fmask_lut (a numpy
    array, closed over as a compile-time constant).
    """
    lutv = jnp.asarray(aerosol_lut)[fmask.astype(jnp.int32)]
    if jnp.issubdtype(jnp.asarray(nir).dtype, jnp.integer):
        # AEROSOL_REMAPPING_MAX_NIR == 1000.0 exactly; nir <= 1000.0 over
        # integers is nir <= 1000
        nir_ok = nir.astype(jnp.int32) <= int(C.AEROSOL_REMAPPING_MAX_NIR)
    else:
        nir_ok = nir <= jnp.float32(C.AEROSOL_REMAPPING_MAX_NIR)

    remapped = jnp.zeros(wtr_1_layer.shape, dtype=bool)
    out = wtr_1_layer
    for bit, input_class in enumerate(_AEROSOL_INPUT_CLASSES):
        hit = (((lutv >> bit) & 1) == 1) & (wtr_1_layer == input_class) \
              & nir_ok
        out = jnp.where(hit, jnp.uint8(C.WATER_UNCOLLAPSED_HIGH_CONF_CLEAR),
                        out)
        remapped = remapped | hit

    set_bit3 = remapped & (cloud_layer != C.UINT8_FILL_VALUE)
    cloud_out = jnp.where(set_bit3, cloud_layer | jnp.uint8(8), cloud_layer)
    return out, cloud_out


def _is_water_class(layer):
    return ((layer >= C.FIRST_UNCOLLAPSED_WATER_CLASS) &
            (layer <= C.LAST_UNCOLLAPSED_WATER_CLASS))


def _nir_gt_lcmask(nir, lcmask_nir):
    """nir > lcmask_nir with float64-exact semantics for integer nir.

    For float (scaled) nir the reference comparison is plain float32
    (NumPy keeps the python-float threshold weak), which the device reproduces
    bit-for-bit; no division is involved.
    """
    if jnp.issubdtype(jnp.asarray(nir).dtype, jnp.integer):
        pq = to_exact_fraction(lcmask_nir, SCALAR_MAX_DEN, SCALAR_MAX_NUM)
        if pq is not None:
            p, q = pq
            return nir.astype(jnp.int32) * q > p
        bound = int_gt_bound(lcmask_nir)
        if bound is None:
            return jnp.zeros(jnp.shape(nir), bool)
        bound = int(np.clip(bound, -2 ** 31 + 1, 2 ** 31 - 1))
        return nir.astype(jnp.int32) >= jnp.int32(bound)
    return nir.astype(jnp.float32) > jnp.float32(lcmask_nir)


def apply_landcover_and_shadow_masks(interpreted_layer, nir, landcover_mask,
                                     shadow_layer,
                                     hls_thresholds: HlsThresholds):
    """WTR-1 -> WTR-2: demote water classes in terrain shadow and over
    evergreen/developed landcover.

    ``landcover_mask`` / ``shadow_layer`` may be None (stages skipped, as in
    the reference).
    """
    out = interpreted_layer
    water = _is_water_class(interpreted_layer)

    if shadow_layer is not None:
        shadowed = (shadow_layer == C.SHAD_MASKED) & water
        if landcover_mask is not None:
            not_water_lc = landcover_mask != \
                C.DSWX_HLS_LANDCOVER_CLASSES_DICT['water']
            shadowed = shadowed & not_water_lc
        out = jnp.where(shadowed, jnp.uint8(C.WATER_NOT_WATER_CLEAR), out)

    if landcover_mask is None:
        return out

    lc = landcover_mask.astype(jnp.int32)
    low_off = C.DSWX_HLS_LANDCOVER_CLASSES_DICT[
        'low_intensity_developed_offset']
    high_off = C.DSWX_HLS_LANDCOVER_CLASSES_DICT[
        'high_intensity_developed_offset']
    evergreen = lc == C.DSWX_HLS_LANDCOVER_CLASSES_DICT['evergreen_forest']
    low_dev = (lc >= low_off) & (lc < low_off + 100)
    high_dev = (lc >= high_off) & (lc < high_off + 100)

    nir_bright = _nir_gt_lcmask(nir, hls_thresholds.lcmask_nir)
    psw = ((interpreted_layer ==
            C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLEAR) |
           (interpreted_layer ==
            C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR))

    # note: the landcover tests read the *input* interpreted layer, exactly
    # as the reference does (it checks `interpreted_layer`, not the partially
    # masked copy; dswx_hls.py:1352-1376)
    demote = ((evergreen & nir_bright & psw) |
              (low_dev & nir_bright & psw) |
              (high_dev & water))
    out = jnp.where(demote, jnp.uint8(C.WATER_NOT_WATER_CLEAR), out)
    return out


def compute_preliminary_cloud_layer(fmask, mask_adjacent_to_cloud_mode: str):
    """Fmask bit decode -> preliminary CLOUD layer (values 0/1/4/5).

    Fmask bits: 1 cloud, 2 adjacent-to-cloud/shadow, 3 cloud shadow.
    Output: cloud-shadow (and adjacent, in 'mask' mode) -> 1; cloud -> +4.
    """
    if mask_adjacent_to_cloud_mode not in ('mask', 'ignore', 'cover'):
        raise ValueError(
            f'ERROR mask adjacent to cloud/cloud-shadow mode:'
            f' {mask_adjacent_to_cloud_mode}')
    f = fmask.astype(jnp.int32)
    shadow = (f & (1 << 3)) != 0
    if mask_adjacent_to_cloud_mode == 'mask':
        shadow = shadow | ((f & (1 << 2)) != 0)
    cloud = (f & (1 << 1)) != 0
    return (shadow.astype(jnp.uint8) + 4 * cloud.astype(jnp.uint8))


def add_snow_to_cloud_layer(wtr_2_layer, cloud_layer, fmask,
                            mask_adjacent_to_cloud_mode: str):
    """Add the snow/ice class (bit 1) to the CLOUD layer; propagate fill.

    In 'cover' mode, snow is dilated (10 iterations) into areas adjacent to
    cloud/shadow, then not-water areas are dilated back (7 iterations) over
    snow that is probably not snow (only over adjacent areas marked as water
    in WTR-2).
    """
    f = fmask.astype(jnp.int32)
    snow_mask = (f & (1 << 4)) != 0

    if mask_adjacent_to_cloud_mode == 'cover':
        adjacent = (f & (1 << 2)) != 0
        areas_to_dilate = adjacent & (cloud_layer == 0)
        snow_mask = binary_dilation_masked(snow_mask, iterations=10,
                                           mask=areas_to_dilate)
        areas_to_dilate = areas_to_dilate & _is_water_class(wtr_2_layer)
        not_masked = (~snow_mask) & (cloud_layer == 0)
        not_masked = binary_dilation_masked(not_masked, iterations=7,
                                            mask=areas_to_dilate)
        snow_mask = snow_mask & ~not_masked

    out = cloud_layer + 2 * snow_mask.astype(jnp.uint8)
    out = jnp.where(wtr_2_layer == C.UINT8_FILL_VALUE,
                    jnp.uint8(C.UINT8_FILL_VALUE), out)
    return out


def apply_cloud_masking(wtr_2_layer, cloud_layer):
    """WTR-2 + CLOUD -> WTR: mark cloud (253) and snow (252) pixels.

    Cloud: any CLOUD value other than 0 (clear) or 8 (aerosol-remapped only).
    Snow: CLOUD exactly 2 or 10 (snow with no cloud/shadow bits). Ocean mask
    and fill pass through from WTR-2.
    """
    cloudy = (cloud_layer != 0) & (cloud_layer != 8)
    snowy = (cloud_layer == 2) | (cloud_layer == 10)
    out = jnp.where(cloudy, jnp.uint8(C.WTR_CLOUD_MASKED), wtr_2_layer)
    out = jnp.where(snowy, jnp.uint8(C.WTR_SNOW_MASKED), out)
    out = jnp.where(wtr_2_layer == C.WTR_OCEAN_MASKED,
                    jnp.uint8(C.WTR_OCEAN_MASKED), out)
    out = jnp.where(wtr_2_layer == C.UINT8_FILL_VALUE,
                    jnp.uint8(C.UINT8_FILL_VALUE), out)
    return out
