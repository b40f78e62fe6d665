"""Adler-32 as data-parallel modular linear algebra.

Capability parity with reference src/adler32.ts (public adler32(source,
seed=1) adler32.ts:17-24; NMAX deferred-modulo serial loop adler32.ts:26-105).
The data-parallel redesign: for bytes x_0..x_{n-1} and seed (s1_0, s2_0),

  s1 = (s1_0 + S) mod 65521,           S = sum x_i
  s2 = (s2_0 + n*s1_0 + W) mod 65521,  W = sum (n - i) * x_i

S and W are per-block partial sums plus a positional correction — both
weights count from the END of the stream, so front zero-padding is free
and blocks combine associatively:

  W = sum_b [ W_b + B * (nb - 1 - b) * S_b ]   (mod 65521)

All block math stays in int32 via mod-safe multiply (split one factor into
8-bit halves) and hierarchical mod-reduction.
"""

from __future__ import annotations

import numpy as np

MOD = 65521
_MASK32 = 0xFFFFFFFF


def _split(seed: int):
    seed = int(seed) & _MASK32
    return seed & 0xFFFF, (seed >> 16) & 0xFFFF


_HOST_BLOCK = 1 << 20
_weights_cache: dict = {}


def _weights(b: int) -> np.ndarray:
    w = _weights_cache.get(b)
    if w is None:
        w = np.arange(b, 0, -1, dtype=np.float64)
        _weights_cache[b] = w
    return w


def adler32_host(data: np.ndarray, seed: int = 1) -> int:
    """Adler-32 of a uint8 array: native serial fold when available, else
    vectorized numpy (BLAS f64 dot products per 1 MiB block — exact
    because every partial sum stays below 2^53)."""
    from ..native.bindings import get_lib

    lib = get_lib()
    if lib is not None and len(data):
        from ..native.api import _p8

        data = np.ascontiguousarray(data)
        return int(
            lib.tz_adler32(_p8(data), np.int64(len(data)),
                           np.uint32(int(seed) & _MASK32))
        )
    n = len(data)
    s1_0, s2_0 = _split(seed)
    if n == 0:
        return ((s2_0 << 16) | s1_0) & _MASK32
    B = _HOST_BLOCK
    w = _weights(B)
    s_total = 0
    w_total = 0
    for start in range(0, n, B):
        x = data[start : start + B]
        m = len(x)
        xf = x.astype(np.float64)
        s_c = int(xf.sum())
        # weight(i) = (m - i) + remaining_after, counted to stream end
        remaining_after = n - (start + m)
        w_c = int(np.dot(w[B - m :], xf)) + (remaining_after % MOD) * s_c
        s_total = (s_total + s_c) % MOD
        w_total = (w_total + w_c) % MOD
    s1 = (s1_0 + s_total) % MOD
    s2 = (s2_0 + (n % MOD) * s1_0 + w_total) % MOD
    return ((s2 << 16) | s1) & _MASK32


# ---------------------------------------------------------------------------
# Device path (JAX)
# ---------------------------------------------------------------------------

_jit_cache = {}

DEVICE_BLOCK = 2048  # 255 * B*(B+1)/2 must stay < 2^31  ->  B <= 4103


def _get_blocks_fn(block: int):
    key = block
    if key in _jit_cache:
        return _jit_cache[key]
    import jax
    import jax.numpy as jnp

    def modmul(a, b):
        # a, b < MOD; exact int32 product mod MOD via 8-bit split of b.
        hi = b >> 8
        lo = b & 0xFF
        return ((a * hi) % MOD * 256 + a * lo) % MOD

    def mod_reduce(v):
        # v: 1-D int32, entries < 2**24; returns scalar sum mod MOD.
        while v.shape[0] > 1:
            k = 128
            padlen = (-v.shape[0]) % k
            v = jnp.pad(v, (0, padlen))
            v = jnp.sum(v.reshape(-1, k), axis=1) % MOD
        return v[0]

    @jax.jit
    def blocks_fn(blocks):
        nb = blocks.shape[0]
        x = blocks.astype(jnp.int32)
        w = jnp.arange(block, 0, -1, dtype=jnp.int32)
        s = jnp.sum(x, axis=1) % MOD
        wsum = jnp.sum(x * w[None, :], axis=1) % MOD
        coef = (nb - 1 - jnp.arange(nb, dtype=jnp.int32)) % MOD
        term = modmul(modmul(coef, s), jnp.int32(block % MOD))
        w_total = mod_reduce((wsum + term) % MOD)
        s_total = mod_reduce(s)
        return s_total, w_total

    _jit_cache[key] = blocks_fn
    return blocks_fn


def adler32_device(data, seed: int = 1, block: int = DEVICE_BLOCK) -> int:
    """Adler-32 on the accelerator: per-block (S, W) sums as one XLA
    reduction over the bytes, then the modular combine on the device."""
    import jax.numpy as jnp

    n = int(data.shape[0])
    s1_0, s2_0 = _split(seed)
    if n == 0:
        return ((s2_0 << 16) | s1_0) & _MASK32
    pad = (-n) % block
    if isinstance(data, np.ndarray):
        padded = np.concatenate([np.zeros(pad, dtype=np.uint8), data])
    else:
        padded = jnp.pad(data, (pad, 0))
    blocks = padded.reshape(-1, block)
    s_total, w_total = _get_blocks_fn(block)(blocks)
    s_total = int(s_total)
    w_total = int(w_total)
    s1 = (s1_0 + s_total) % MOD
    s2 = (s2_0 + (n % MOD) * s1_0 + w_total) % MOD
    return ((s2 << 16) | s1) & _MASK32


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """Adler of concat(A, B) from adler(A), adler(B), len(B)."""
    s1a, s2a = _split(adler1)
    s1b, s2b = _split(adler2)
    len2 %= MOD
    s1 = (s1a + s1b - 1) % MOD
    s2 = (s2a + s2b + len2 * (s1a - 1 + MOD)) % MOD
    return ((s2 << 16) | s1) & _MASK32
