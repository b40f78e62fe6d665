"""CRC-32 block forms as one fused Pallas kernel (Triton route).

The plain form (crc32.forms_xla) writes the 8x bit expansion of the
input to device memory and reads it back for the matmul.  This kernel
keeps it on chip: each program loads TILE blocks of BLOCK bytes, unpacks
one bit plane at a time in registers, multiplies it against that plane
of the (8, BLOCK, 32) GF(2) block matrix with int8 operands and exact
int32 accumulation, and writes only the 4-byte form per block — about
1 + 4/BLOCK bytes of device-memory traffic per input byte.

Accumulation is exact: a form bit sums at most 8 * BLOCK products of
0/1 values before the parity is taken.
"""

from __future__ import annotations

import functools

import numpy as np

from . import crc32 as crc_k

BLOCK = crc_k.DEVICE_BLOCK  # bytes per CRC block
TILE = 256  # blocks per program
SPAN = BLOCK * TILE  # input bytes per program


def _interpret() -> bool:
    """Compiled through Triton on the GPU, interpreted on the CPU (tests);
    no other backend is supported."""
    import jax

    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise NotImplementedError(
        f"crc32_pallas targets the GPU (Triton) or the CPU interpreter, "
        f"not {backend!r}"
    )


@functools.lru_cache()
def _plane_matrix() -> np.ndarray:
    """(8, BLOCK, 32) int8: plane i holds the rows of bit i of each byte."""
    m = crc_k.block_matrix_bits(BLOCK)  # row j*8 + i
    return np.stack([m[i::8] for i in range(8)])


def _kernel(x_ref, m_ref, o_ref):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    x = x_ref[...]  # (TILE, BLOCK) u8
    acc = jnp.zeros((TILE, 32), jnp.int32)
    for i in range(8):
        plane = ((x >> i) & 1).astype(jnp.int8)
        acc += pl.dot(plane, m_ref[i])  # int8 x int8 -> int32
    shifts = jax.lax.broadcasted_iota(jnp.uint32, (TILE, 32), 1)
    o_ref[...] = jnp.sum((acc & 1).astype(jnp.uint32) << shifts, axis=1)


def forms(blocks):
    """Per-block raw CRC linear forms: (nb, BLOCK) u8 -> (nb,) u32, nb a
    multiple of TILE.  Traceable."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    nb = blocks.shape[0]
    return pl.pallas_call(
        _kernel,
        out_shape=jax.ShapeDtypeStruct((nb,), jnp.uint32),
        grid=(nb // TILE,),
        in_specs=[
            pl.BlockSpec((TILE, BLOCK), lambda i: (i, 0)),
            pl.BlockSpec((8, BLOCK, 32), lambda i: (0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((TILE,), lambda i: (i,)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=_interpret(),
        name="crc32_forms",
    )(blocks, jnp.asarray(_plane_matrix()))
