"""CRC-32 (poly 0xEDB88320) as data-parallel GF(2) linear algebra.

Capability parity with reference src/crc32.ts (public crc32(source, seed=0)
crc32.ts:17-23; slice-by-4 serial table kernel crc32.ts:48-106).  The
data-parallel redesign replaces the serial byte fold with:

  1. per-block linear forms: for a B-byte block, the raw CRC register
     contribution  G = L(block)  is a GF(2)-linear function of the block's
     bits, computed as a bit-matrix product  bits(1, 8B) @ M_B(8B, 32) mod 2
     — an int8 matmul with exact int32 accumulation, batched over
     thousands of blocks at once;
  2. an associative log-depth combine across blocks using the byte-shift
     matrix A (raw-register propagation through one zero byte):
     raw(b0|b1) = A^B raw(b0) ^ raw(b1).

Key identities (raw register r = public_crc ^ 0xFFFFFFFF):
  fold_raw(r, data) = L(data) ^ A^n r         (linear, no affine offset)
  L(zeros_k | data) = L(data)                 (front-padding is free)
"""

from __future__ import annotations

import functools

import numpy as np

from . import gf2

POLY = np.uint32(0xEDB88320)
_MASK32 = 0xFFFFFFFF

# Block sizes: the host fold favors wide lanes / short folds; the device
# block keeps the (8B, 32) GF(2) matrix at 16 KiB of int8.
HOST_BLOCK = 256
DEVICE_BLOCK = 64


@functools.lru_cache()
def _table8() -> np.ndarray:
    """Standard 256-entry CRC table (used by the host fold and to derive
    the GF(2) matrices; the table itself is a linear map on byte bits)."""
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> np.uint32(1)) ^ POLY, t >> np.uint32(1))
    return t


@functools.lru_cache()
def byte_shift_matrix() -> np.ndarray:
    """A: raw-register propagation through one zero data byte.

    r' = table[r & 0xFF] ^ (r >> 8)  — linear in r.
    """
    t = _table8()
    cols = np.zeros(32, dtype=np.uint32)
    for i in range(32):
        v = np.uint32(1) << np.uint32(i)
        cols[i] = t[int(v) & 0xFF] ^ np.uint32(int(v) >> 8)
    return cols


@functools.lru_cache(maxsize=256)
def shift_matrix(n_bytes: int) -> np.ndarray:
    """A^n: raw-register propagation through n zero data bytes."""
    return gf2.matpow(byte_shift_matrix(), n_bytes)


@functools.lru_cache(maxsize=64)
def _combine_tables(block: int, level: int) -> np.ndarray:
    """Byte-decomposed lookup tables for A^(block * 2^level)."""
    if level == 0:
        mat = shift_matrix(block)
    else:
        prev_mat = _combine_mat(block, level - 1)
        mat = gf2.matmul(prev_mat, prev_mat)
    return gf2.lookup_tables(mat)


@functools.lru_cache(maxsize=64)
def _combine_mat(block: int, level: int) -> np.ndarray:
    if level == 0:
        return shift_matrix(block)
    prev = _combine_mat(block, level - 1)
    return gf2.matmul(prev, prev)


@functools.lru_cache()
def block_matrix_bits(block: int) -> np.ndarray:
    """M_B as an (8*B, 32) int8 bit matrix for the device matmul.

    Row (j*8 + i) is L(e) for the block with byte value (1 << i) at
    position j: equal to A^(B-1-j) applied to table[1 << i].
    """
    t = _table8()
    a = byte_shift_matrix()
    rows = np.zeros((block, 8), dtype=np.uint32)
    cur = t[(np.uint32(1) << np.arange(8, dtype=np.uint32)).astype(np.int64)]
    for k in range(block):
        rows[block - 1 - k] = cur
        if k + 1 < block:
            cur = gf2.apply_many(a, cur)
    packed = rows.reshape(block * 8)
    bits = ((packed[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1).astype(
        np.int8
    )
    return bits


def _fold_lanes(blocks: np.ndarray) -> np.ndarray:
    """Per-lane raw fold with zero seeds: G[b] = L(blocks[b]).

    Serial over block bytes, vectorized across lanes (the host analog of
    the device matmul)."""
    t = _table8()
    crc = np.zeros(blocks.shape[0], dtype=np.uint32)
    for j in range(blocks.shape[1]):
        crc = t[((crc ^ blocks[:, j]) & 0xFF).astype(np.int64)] ^ (crc >> np.uint32(8))
    return crc


def _combine_blocks(g: np.ndarray, block: int) -> int:
    """Fold per-block linear forms into L(data) via a log-depth tree.

    g[0] is the earliest block.  Pads at the FRONT with zeros (free in the
    raw domain)."""
    nb = len(g)
    if nb == 0:
        return 0
    size = 1 << max(0, (nb - 1).bit_length())
    if size != nb:
        g = np.concatenate([np.zeros(size - nb, dtype=np.uint32), g])
    level = 0
    while len(g) > 1:
        tables = _combine_tables(block, level)
        g = gf2.apply_tables(tables, g[0::2]) ^ g[1::2]
        level += 1
    return int(g[0])


def _finish(l_data: int, n: int, seed: int) -> int:
    raw_seed = (int(seed) & _MASK32) ^ _MASK32
    raw = l_data ^ gf2.apply(shift_matrix(n), raw_seed)
    return (raw ^ _MASK32) & _MASK32


def crc32_host(data: np.ndarray, seed: int = 0) -> int:
    """CRC-32 of a uint8 array: native slice-by-8 when available, else the
    vectorized-numpy GF(2) fold (the device kernel's algorithmic mirror)."""
    n = len(data)
    if n == 0:
        return int(seed) & _MASK32
    from ..native.bindings import get_lib

    lib = get_lib()
    if lib is not None:
        from ..native.api import _p8

        data = np.ascontiguousarray(data)
        return int(
            lib.tz_crc32(_p8(data), np.int64(n),
                         np.uint32(int(seed) & _MASK32))
        )
    block = min(HOST_BLOCK, max(8, n))
    pad = (-n) % block
    padded = np.concatenate([np.zeros(pad, dtype=np.uint8), data])
    blocks = padded.reshape(-1, block)
    g = _fold_lanes(blocks)
    l_data = _combine_blocks(g, block)
    return _finish(l_data, n, seed)


# ---------------------------------------------------------------------------
# Device path (JAX)
# ---------------------------------------------------------------------------


def forms_xla(blocks):
    """Per-block raw linear forms L(block) of (nb, B) u8 blocks -> (nb,)
    u32, as plain XLA: the 8x bit expansion and one int8 matmul with
    exact int32 accumulation.  The reference for the fused kernel in
    crc32_pallas."""
    import jax
    import jax.numpy as jnp

    nb, block = blocks.shape
    m_bits = jnp.asarray(block_matrix_bits(block))  # (8B, 32) int8
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (blocks[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1)
    acc = jax.lax.dot_general(
        bits.reshape(nb, block * 8).astype(jnp.int8),
        m_bits,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    g = (acc & 1).astype(jnp.uint32)
    return jnp.sum(
        g << jnp.arange(32, dtype=jnp.uint32)[None, :], axis=1, dtype=jnp.uint32
    )


def combine_device(g, block: int):
    """Fold per-block forms (earliest first) into L(data) on the device:
    a log-depth tree of byte-table GF(2) matrix applications.  Front
    padding with zero forms is free in the raw domain."""
    import jax.numpy as jnp

    nb = g.shape[0]
    size = 1 << max(0, (nb - 1).bit_length())
    if size != nb:
        g = jnp.concatenate([jnp.zeros(size - nb, jnp.uint32), g])
    level = 0
    while g.shape[0] > 1:
        t = jnp.asarray(_combine_tables(block, level))
        left, right = g[0::2], g[1::2]
        g = (
            t[0][(left & 0xFF).astype(jnp.int32)]
            ^ t[1][((left >> jnp.uint32(8)) & 0xFF).astype(jnp.int32)]
            ^ t[2][((left >> jnp.uint32(16)) & 0xFF).astype(jnp.int32)]
            ^ t[3][(left >> jnp.uint32(24)).astype(jnp.int32)]
            ^ right
        )
        level += 1
    return g[0]


def linear_form_device(data):
    """Raw linear form L(data) of a flat u8 device array, as a u32 device
    scalar (traceable): the fused kernel's block forms (crc32_pallas)
    and the device combine."""
    import jax.numpy as jnp

    from .crc32_pallas import SPAN, forms

    n = data.shape[0]
    padded = jnp.pad(data, ((-n) % SPAN, 0))
    return combine_device(forms(padded.reshape(-1, DEVICE_BLOCK)), DEVICE_BLOCK)


@functools.lru_cache()
def _linear_form_jit():
    import jax

    return jax.jit(linear_form_device)


def crc32_device(data, seed: int = 0) -> int:
    """CRC-32 of a u8 numpy or device array with the block forms and
    their combine on the accelerator; only the seed finish (one 32x32
    GF(2) product) runs on the host."""
    n = int(data.shape[0])
    if n == 0:
        return int(seed) & _MASK32
    l_data = int(_linear_form_jit()(data))
    return _finish(l_data, n, seed)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concat(A, B) from crc(A), crc(B), len(B).

    The associative combine used to merge shard-local CRCs across chips.
    """
    raw2 = (int(crc2) & _MASK32) ^ _MASK32
    shifted = gf2.apply(shift_matrix(len2), int(crc1) & _MASK32)
    return (shifted ^ raw2 ^ _MASK32) & _MASK32
