"""The fused DSWx-HLS device chain: HLS bands in, all product layers out.

This is the device replacement for the reference orchestrator's sequence of
NumPy stages (dswx_hls.py:5089-5368): one jit-compiled function evaluates
DIAG -> WTR-1 -> (aerosol) -> WTR-2 -> CLOUD -> WTR -> BWTR/CONF/BROWSE plus
the coverage statistics, entirely on device. XLA fuses the elementwise
stages.

The chain is pure: all configuration is compile-time static
(``DswxChainConfig``), all data are arrays. Batched execution (campaign
mode) vmaps/shard_maps this same function.
"""

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from proteus_jax.core import constants as C
from proteus_jax.core.thresholds import HlsThresholds
from proteus_jax.models.dswx import masking
from proteus_jax.models.dswx.browse import compute_browse_array
from proteus_jax.models.dswx.diagnostics import (compute_diagnostic_tests,
                                                 get_binary_representation)
from proteus_jax.models.dswx.interpretation import (generate_interpreted_layer,
                                                    get_binary_water_layer,
                                                    get_confidence_layer)


@dataclasses.dataclass(frozen=True)
class DswxChainConfig:
    """Compile-time configuration of the device chain (hashable/static)."""
    thresholds: HlsThresholds = HlsThresholds()
    mask_adjacent_to_cloud_mode: str = 'mask'
    apply_aerosol_class_remapping: bool = True
    aerosol_not_water_fmask_values: Tuple[int, ...] = (224, 160, 96)
    aerosol_moderate_conf_fmask_values: Tuple[int, ...] = (224, 160, 96)
    aerosol_psw_conservative_fmask_values: Tuple[int, ...] = \
        (224, 192, 160, 128, 96)
    aerosol_psw_aggressive_fmask_values: Tuple[int, ...] = \
        (224, 192, 160, 128, 96)
    # ancillary-stage parameters (used by the terrain-shadow and LAND
    # builders, not by the per-pixel chain itself)
    min_slope_angle: float = -5.0
    max_sun_local_inc_angle: float = 40.0
    shadow_masking_algorithm: str = 'sun_local_inc_angle'
    forest_mask_landcover_classes: Tuple[int, ...] = \
        (20, 50, 111, 113, 115, 116, 121, 123, 125, 126)
    # browse options
    exclude_psw_aggressive_in_browse: bool = True
    not_water_in_browse: str = 'white'
    cloud_in_browse: str = 'gray'
    snow_in_browse: str = 'cyan'
    flag_collapse_wtr_classes: bool = C.FLAG_COLLAPSE_WTR_CLASSES

    def aerosol_lut(self):
        return masking.build_aerosol_fmask_lut(
            self.aerosol_not_water_fmask_values,
            self.aerosol_moderate_conf_fmask_values,
            self.aerosol_psw_conservative_fmask_values,
            self.aerosol_psw_aggressive_fmask_values)


def dswx_chain(blue, green, red, nir, swir1, swir2, fmask, invalid_mask,
               config: DswxChainConfig,
               ocean_mask=None, shadow_layer=None, landcover_mask=None,
               compute_browse: bool = True, compute_stats: bool = True):
    """Run the full per-pixel DSWx-HLS science chain on device.

    Parameters
    ----------
    blue..swir2 : (H, W) int16 (unscaled, negative-clipped) or float32
        (scaled) reflectance arrays.
    fmask : (H, W) integer HLS Fmask.
    invalid_mask : (H, W) bool — cumulative fill-pixel mask from ingest.
    ocean_mask : optional (H, W) uint8/bool — 1 land / 0 ocean.
    shadow_layer : optional (H, W) uint8/bool — 1 not-shadow / 0 shadow.
    landcover_mask : optional (H, W) uint8 LAND classes.

    Returns
    -------
    dict with layers 'DIAG' (uint16 pseudo-binary), 'WTR-1', 'WTR-2', 'WTR',
    'BWTR', 'CONF', 'CLOUD', optional 'BROWSE' (uint8), plus scalar coverage
    counters 'n_valid', 'n_cloud_and_valid', 'n_not_ocean'.
    """
    fill = jnp.uint8(C.UINT8_FILL_VALUE)

    diag_decimal = compute_diagnostic_tests(blue, green, red, nir, swir1,
                                            swir2, config.thresholds)
    diag_decimal = jnp.where(invalid_mask,
                             jnp.uint16(C.DIAGNOSTIC_LAYER_NO_DATA_DECIMAL),
                             diag_decimal)

    wtr1 = generate_interpreted_layer(diag_decimal)
    diag = get_binary_representation(diag_decimal)

    if ocean_mask is not None:
        wtr1 = jnp.where(ocean_mask == 0, jnp.uint8(C.WTR_OCEAN_MASKED), wtr1)
    wtr1 = jnp.where(invalid_mask, fill, wtr1)

    # the saved WTR-1 layer excludes the aerosol remapping (the reference
    # saves WTR-1 before mutating it in place; dswx_hls.py:5251-5266)
    wtr1_product = wtr1

    cloud = masking.compute_preliminary_cloud_layer(
        fmask, config.mask_adjacent_to_cloud_mode)

    # coverage statistics (computed on the preliminary cloud layer, before
    # aerosol; dswx_hls.py:5104-5111)
    if compute_stats:
        valid = ~jnp.asarray(invalid_mask, dtype=bool)
        if ocean_mask is not None:
            valid = valid & (ocean_mask != 0)
            n_not_ocean = jnp.sum((ocean_mask != 0).astype(jnp.int32))
        else:
            n_not_ocean = jnp.asarray(valid.size, dtype=jnp.int32)
        n_valid = jnp.sum(valid.astype(jnp.int32))
        n_cloud_and_valid = jnp.sum(((cloud != 0)
                                     & valid).astype(jnp.int32))

    if config.apply_aerosol_class_remapping:
        wtr1, cloud = masking.apply_aerosol_class_remapping(
            wtr1, nir, cloud, fmask, config.aerosol_lut())

    wtr2 = masking.apply_landcover_and_shadow_masks(
        wtr1, nir, landcover_mask, shadow_layer, config.thresholds)

    cloud = masking.add_snow_to_cloud_layer(
        wtr2, cloud, fmask, config.mask_adjacent_to_cloud_mode)

    wtr = masking.apply_cloud_masking(wtr2, cloud)

    bwtr = get_binary_water_layer(wtr)
    conf = get_confidence_layer(wtr2, cloud)

    out = {
        'DIAG': diag,
        'WTR-1': wtr1_product,
        'WTR-2': wtr2,
        'WTR': wtr,
        'BWTR': bwtr,
        'CONF': conf,
        'CLOUD': cloud,
    }
    if compute_stats:
        out['n_valid'] = n_valid
        out['n_cloud_and_valid'] = n_cloud_and_valid
        out['n_not_ocean'] = n_not_ocean
    if compute_browse:
        out['BROWSE'] = compute_browse_array(
            wtr,
            flag_collapse_wtr_classes=config.flag_collapse_wtr_classes,
            exclude_psw_aggressive=config.exclude_psw_aggressive_in_browse,
            set_not_water_to_nodata=(config.not_water_in_browse == 'nodata'),
            set_cloud_to_nodata=(config.cloud_in_browse == 'nodata'),
            set_snow_to_nodata=(config.snow_in_browse == 'nodata'),
            set_ocean_masked_to_nodata=True)
    return out


def make_jitted_chain(config: DswxChainConfig, with_ocean=False,
                      with_shadow=False, with_landcover=False,
                      compute_browse=True):
    """Build a jit-compiled chain with the config baked in.

    The returned function takes positional arrays only — the six bands,
    fmask, invalid mask, then the enabled ancillary masks in
    (ocean, shadow, landcover) order — so it never retraces across tiles.
    """
    def fn(blue, green, red, nir, swir1, swir2, fmask, invalid_mask,
           *extras):
        it = iter(extras)
        ocean = next(it) if with_ocean else None
        shadow = next(it) if with_shadow else None
        landcover = next(it) if with_landcover else None
        return dswx_chain(blue, green, red, nir, swir1, swir2, fmask,
                          invalid_mask, config, ocean_mask=ocean,
                          shadow_layer=shadow, landcover_mask=landcover,
                          compute_browse=compute_browse)
    return jax.jit(fn)
