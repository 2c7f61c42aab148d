"""SHAD bit-packing: the device packer and the writer's host unpack.

The campaign keeps the binary SHAD layer on device and copies it to the
writer pool as 1 bit/px; the round trip must be lossless at every row
width, including widths that are not a multiple of 8.
"""

import numpy as np

RNG = np.random.default_rng(77)


def test_pack_bits_roundtrip():
    from proteus_jax.parallel.campaign import pack_bits_device, unpack_bits
    import jax.numpy as jnp
    for w in (96, 97, 103):
        x = (RNG.random((33, w)) < 0.5).astype(np.uint8)
        packed = np.asarray(pack_bits_device(jnp.asarray(x)))
        assert packed.shape == (33, (w + 7) // 8)
        np.testing.assert_array_equal(unpack_bits(packed, w), x)
