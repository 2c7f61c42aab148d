#!/usr/bin/env python3
"""DSWx-HLS product generation on JAX. See proteus_jax.cli.dswx_hls.

References:
[1] J. W. Jones, "Efficient wetland surface water detection and monitoring
    via Landsat", Remote Sensing, 7(9), 12503-12538, 2015.
[2] R. Dittmeier, "LANDSAT DYNAMIC SURFACE WATER EXTENT (DSWE) ALGORITHM
    DESCRIPTION DOCUMENT (ADD)", USGS, March 2018.
"""

from proteus_jax.cli.dswx_hls import main

if __name__ == '__main__':
    main()
