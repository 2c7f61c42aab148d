"""Build the native tiffturbo codec (g++ -O3 -shared).

Prefers libdeflate for the DEFLATE paths (5-25x faster than zlib on raster
tiles); falls back to a zlib-only build when libdeflate headers are absent.

Usage: python -m proteus_jax.native.build
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, 'tiffturbo.cpp')
LIB = os.path.join(HERE, 'libtiffturbo.so')


def build(verbose=True):
    base = ['g++', '-O3', '-march=native', '-shared', '-fPIC',
            '-std=c++17', SRC, '-o', LIB]
    attempts = [
        base + ['-DTT_USE_LIBDEFLATE', '-ldeflate', '-lpthread'],
        base + ['-lz', '-lpthread'],
    ]
    last_err = None
    for cmd in attempts:
        if verbose:
            print(' '.join(cmd))
        try:
            subprocess.run(cmd, check=True, capture_output=not verbose)
            return LIB
        except subprocess.CalledProcessError as exc:
            last_err = exc
    raise last_err


def lib_is_fresh():
    return (os.path.isfile(LIB)
            and os.path.getmtime(LIB) >= os.path.getmtime(SRC))


if __name__ == '__main__':
    build()
    print(f'built {LIB}')
    sys.exit(0)
