"""Shared device-deflate building blocks (v3 support module).

The v1 static-tree and v2 gather-light encoder generations that used to
live here are retired: round 4 removed their unused halves, and round 5
ported the mesh pipeline (parallel/pipeline.py) to the flagship v3
encoder (kernels/deflate_device3.py), so only the pieces v3 and the
pipeline actually share remain:

  CTX / SEG            — window-context and parse-segment constants
  _build_w32           — per-byte u32 little-endian window views
  segment_parse_xla    — pointer-doubling token-start extraction
  sym_fields_v2        — arithmetic RFC 1951 symbol decomposition
  _push_words          — device words -> BitSink host join

Capability parity: the parse/emission halves of reference
src/deflate.ts deflate_slow + bit packer (deflate.ts:827-946, :352-374).
"""

from __future__ import annotations

import numpy as np

from ..codec.tables import WINDOW_SIZE

CTX = WINDOW_SIZE  # fixed-size history prefix carried between chunks
# forced token-break period (parse segment length).  A longer segment
# cuts fewer matches and costs one more doubling round of the parse per
# doubling; chunk sizes of batched encodes must be multiples of it.
SEG = 4096


def _build_w32(jnp, data):
    """Per-byte uint32 little-endian windows (bits 8k..8k+31)."""
    n = data.shape[0]
    padded = jnp.concatenate([data, jnp.zeros(8, dtype=jnp.uint8)]).astype(jnp.uint32)
    w = padded[:n]
    w = w | (padded[1 : 1 + n] << jnp.uint32(8))
    w = w | (padded[2 : 2 + n] << jnp.uint32(16))
    w = w | (padded[3 : 3 + n] << jnp.uint32(24))
    return w


def segment_parse_xla(jax, jnp, step, n_valid, seg=SEG):
    """Token starts from a step tape with forced breaks every `seg`.

    step[i] >= 1 never crosses a segment boundary (caller enforces), so
    chains are segment-local and ceil(log2(seg)) scatter+gather doubling
    rounds suffice.  Returns bool[n] token-start mask."""
    n = step.shape[0]
    t = jnp.arange(n, dtype=jnp.int32) % seg
    base = jnp.arange(n, dtype=jnp.int32) - t
    nxt = base + jnp.minimum(t + step, seg)
    nxt = jnp.where(jnp.arange(n) >= n_valid, n, jnp.minimum(nxt, n))
    J = jnp.concatenate([nxt, jnp.array([n], jnp.int32)])
    nseg = -(-n // seg)
    seeds = jnp.arange(nseg, dtype=jnp.int32) * seg
    reach = (J * 0).at[jnp.minimum(seeds, n)].set(1)
    rounds = max(1, int(np.ceil(np.log2(seg + 1))))

    def dbl(_, state):
        reach, Jk = state
        return reach.at[Jk].max(reach[: Jk.shape[0]]), Jk[Jk]

    reach, _ = jax.lax.fori_loop(0, rounds, dbl, (reach, J))
    return reach[:n].astype(bool) & (jnp.arange(n) < n_valid)


def _floor_log2(jax, jnp, v):
    """floor(log2(v)) for int32 v >= 1 (exact for v < 2^24)."""
    f = v.astype(jnp.float32)
    return (
        jax.lax.bitcast_convert_type(f, jnp.uint32) >> jnp.uint32(23)
    ).astype(jnp.int32) - 127


def sym_fields_v2(jax, jnp, litlen, dist, is_match):
    """Arithmetic litlen/dist symbol mapping (no 32K-table gathers).

    Returns (lsym, lext_bits, lext_val, dsym, dext_bits, dext_val) —
    the RFC 1951 code-point decomposition computed elementwise via the
    float-exponent trick (exact: all operands < 2^16)."""
    l = jnp.clip(litlen - 3, 0, 255)
    e = _floor_log2(jax, jnp, jnp.maximum(l, 1))
    sub = (l >> jnp.maximum(e - 2, 0)) & 3
    lsym_m = jnp.where(
        l < 8, 257 + l, jnp.where(l == 255, 285, 253 + 4 * e + sub)
    )
    lsym = jnp.where(is_match, lsym_m, litlen)
    lext = jnp.where((l < 8) | (l == 255), 0, jnp.maximum(e - 2, 0))
    lext = jnp.where(is_match, lext, 0)
    lext_val = jnp.where(is_match, l & ((1 << lext) - 1), 0)

    v = jnp.clip(dist - 1, 0, WINDOW_SIZE - 1)
    ed = _floor_log2(jax, jnp, jnp.maximum(v, 1))
    dsym = jnp.where(v < 4, v, 2 * ed + ((v >> jnp.maximum(ed - 1, 0)) & 1))
    dext = jnp.where((v < 4) | ~is_match, 0, jnp.maximum(ed - 1, 0))
    dext_val = jnp.where(is_match, v & ((1 << dext) - 1), 0)
    return lsym, lext, lext_val, dsym, dext, dext_val


def _push_words(sink, words, total_bits):
    words = np.asarray(words)
    total_bits = int(total_bits)
    nfull = total_bits >> 5
    if nfull:
        sink.push(words[:nfull].astype(np.uint64), np.full(nfull, 32, dtype=np.int64))
    rem = total_bits & 31
    if rem:
        sink.push_scalar(int(words[nfull]) & ((1 << rem) - 1), rem)
