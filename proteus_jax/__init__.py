"""proteus_jax — a JAX framework with the capabilities of NASA/JPL's
PROTEUS (DSWx-HLS Science Application Software).

The per-pixel science core (spectral indices, diagnostic tests, class
interpretation, aerosol/landcover/shadow/cloud masking) runs as fused JAX/XLA
kernels on device-resident tile tensors; GeoTIFF/COG I/O,
reprojection planning, runconfig parsing, and metadata stay on host. Campaign
mode shards batched tile stacks across the local GPUs via ``jax.sharding``.

Layer map (each module's docstring cites the reference behavior it matches):

- ``proteus_jax.config``    runconfig system (defaults + schema + deep-merge)
- ``proteus_jax.core``      science constants / thresholds (pytrees)
- ``proteus_jax.models``    the DSWx-HLS product chain (pure jax functions)
- ``proteus_jax.ops``       reusable device ops (LUTs, morphology, resampling,
                            Otsu)
- ``proteus_jax.geo``       CRS math (UTM/WGS84/MGRS), warp-as-gather, polygons
- ``proteus_jax.io``        GeoTIFF/COG codec, HLS readers, shapefile, PNG
- ``proteus_jax.parallel``  campaign sharding (mesh, shard_map, manifest)
- ``proteus_jax.runtime``   orchestrator, metadata, logging, comparator
- ``proteus_jax.cli``       command-line entry points
- ``proteus_jax.utils``     compile cache, GPU identity
"""

from proteus_jax.version import VERSION

__version__ = VERSION


def generate_dswx_layers(*args, **kwargs):
    """Library API (reference-compatible); see
    proteus_jax.runtime.orchestrator.generate_dswx_layers."""
    from proteus_jax.runtime.orchestrator import generate_dswx_layers as f
    return f(*args, **kwargs)


def compare_dswx_hls_products(*args, **kwargs):
    from proteus_jax.runtime.compare import compare_dswx_hls_products as f
    return f(*args, **kwargs)


def save_as_cog(*args, **kwargs):
    from proteus_jax.io.cog import save_as_cog as f
    return f(*args, **kwargs)
