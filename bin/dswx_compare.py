#!/usr/bin/env python3
"""Compare two DSWx-HLS products. See proteus_jax.cli.dswx_compare."""

from proteus_jax.cli.dswx_compare import main

if __name__ == '__main__':
    main()
