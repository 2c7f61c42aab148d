"""DIAG -> WTR-1 interpretation, class collapse, BWTR and CONF layers.

All of these are tiny lookup tables / masked rewrites over uint8 class maps;
on device they compile to a single gather or a few selects per pixel and fuse
with neighboring stages.

Reference behaviors matched:
  - generate_interpreted_layer        dswx_hls.py:1687-1707
  - _collapse_wtr_classes             dswx_hls.py:2578-2598
  - _get_binary_water_layer           dswx_hls.py:1710-1730
  - _get_confidence_layer             dswx_hls.py:1733-1837
"""

import jax.numpy as jnp
import numpy as np

from proteus_jax.core import constants as C


_INTERP_LUT = C.build_interpretation_lut()          # 33 entries
_COLLAPSE_LUT = C.build_collapse_lut()              # 256 entries


def generate_interpreted_layer(diagnostic_layer_decimal):
    """Map the 5-bit DIAG decimal value to water classes (WTR-1), uint8.

    Unknown values map to UINT8_FILL_VALUE.
    """
    lut = jnp.asarray(_INTERP_LUT)
    idx = jnp.clip(diagnostic_layer_decimal.astype(jnp.int32), 0,
                   len(_INTERP_LUT) - 1)
    out = lut[idx]
    # values beyond the table (cannot occur for 5-bit diag + fill, but match
    # the reference's "unknown -> 255" contract)
    out = jnp.where(diagnostic_layer_decimal.astype(jnp.int32)
                    > len(_INTERP_LUT) - 1,
                    jnp.uint8(C.UINT8_FILL_VALUE), out)
    return out


def collapse_wtr_classes(interpreted_layer):
    """Collapse the 4 internal water classes to the 2 product classes."""
    lut = jnp.asarray(_COLLAPSE_LUT)
    return lut[interpreted_layer.astype(jnp.int32)]


def get_binary_water_layer(wtr_layer):
    """BWTR: classes 1..4 -> 1; everything else passes through."""
    is_water = (wtr_layer >= C.FIRST_UNCOLLAPSED_WATER_CLASS) & \
               (wtr_layer <= C.LAST_UNCOLLAPSED_WATER_CLASS)
    return jnp.where(is_water, jnp.uint8(C.BWTR_WATER), wtr_layer)


def _conf_luts():
    """256-entry LUTs for the CONF layer cloud/snow class rewrites."""
    cloud_lut = np.arange(256, dtype=np.uint8)
    snow_lut = np.arange(256, dtype=np.uint8)
    # clear class c (0..4) -> c+10 under cloud, c+20 under snow
    for c in range(5):
        cloud_lut[c] = c + 10
        snow_lut[c] = c + 20
    return cloud_lut, snow_lut


_CONF_CLOUD_LUT, _CONF_SNOW_LUT = _conf_luts()

# 256-entry boolean LUT: CLOUD value -> "counts as cloud in CONF"
_CONF_CLOUD_VALUES_LUT = np.zeros(256, dtype=bool)
for _v in C.CONF_CLOUD_VALUES:
    _CONF_CLOUD_VALUES_LUT[_v] = True


def get_confidence_layer(wtr_2_layer, cloud_layer):
    """CONF layer: uncollapsed WTR-2 with +10 (cloud) / +20 (snow) offsets.

    Cloud (any CLOUD value in CONF_CLOUD_VALUES) has precedence over snow
    (CLOUD == 2 exactly). Ocean-masked and fill values pass through.
    """
    cloud_idx = jnp.asarray(_CONF_CLOUD_VALUES_LUT)[
        cloud_layer.astype(jnp.int32)]
    snow_idx = cloud_layer == C.CONF_SNOW_VALUE

    cloud_mapped = jnp.asarray(_CONF_CLOUD_LUT)[wtr_2_layer.astype(jnp.int32)]
    snow_mapped = jnp.asarray(_CONF_SNOW_LUT)[wtr_2_layer.astype(jnp.int32)]

    conf = jnp.where(cloud_idx, cloud_mapped, wtr_2_layer)
    # snow applies only where not already rewritten by cloud (the reference
    # checks conf_layer == clear-class values, which the cloud pass already
    # consumed)
    conf = jnp.where(snow_idx & ~cloud_idx, snow_mapped, conf)
    return conf.astype(jnp.uint8)
