"""Pass 2 of the two-pass inflate: token tape -> bytes.

Redesign of the reference's serial window copier (src/infcodes.ts:159-207
LZ back-copy, src/infblocks.ts:61-121 inflate_flush): LZ back-references
are resolved data-parallel.  Every output byte gets an "immediate source"
pointer (literals and window bytes are roots holding values; copy bytes
point dist back, with the classic mod-dist rewrite making self-overlapping
copies point strictly before their own token).  Pointer-doubling then
resolves every byte to its root literal in O(log n) gather rounds — the
ACEAPEX-style scheme (see PAPERS.md) that maps 1:1 onto device gathers.
"""

from __future__ import annotations

import numpy as np

from .tokenize import DataError


def _expand_native(litlen, dist, window):
    import ctypes

    try:
        from ..native.bindings import get_lib, native_available

        if not native_available():
            return None
        lib = get_lib()
    except Exception:  # pragma: no cover
        return None
    litlen = np.ascontiguousarray(litlen, dtype=np.int32)
    dist = np.ascontiguousarray(dist, dtype=np.int32)
    is_copy = dist > 0
    total = int(np.where(is_copy, litlen, 1).sum())
    wlen = len(window)
    dst = np.empty(wlen + total, dtype=np.uint8)
    if wlen:
        dst[:wlen] = window
    p32 = ctypes.POINTER(ctypes.c_int32)
    out = lib.tz_expand_tokens(
        litlen.ctypes.data_as(p32),
        dist.ctypes.data_as(p32),
        np.int64(len(litlen)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int64(len(dst)),
        np.int64(wlen),
    )
    if out == -2:
        raise DataError("invalid distance too far back")
    if out < 0:  # pragma: no cover
        return None
    return dst[wlen : wlen + out]


def expand_host(
    litlen: np.ndarray, dist: np.ndarray, window: np.ndarray
) -> np.ndarray:
    """Expand a token tape against a history window; returns new bytes.

    window: previous output/dictionary context (up to 32 KiB), index -1
    is the byte immediately before the first output byte of this tape.
    Dispatches to the native serial expander when available; the
    vectorized pointer-doubling below is the device-algorithm reference.
    """
    ntok = len(litlen)
    if ntok == 0:
        return np.empty(0, dtype=np.uint8)
    native = _expand_native(litlen, dist, window)
    if native is not None:
        return native
    is_copy = dist > 0
    out_lens = np.where(is_copy, litlen, 1).astype(np.int64)
    starts = np.zeros(ntok + 1, dtype=np.int64)
    np.cumsum(out_lens, out=starts[1:])
    total = int(starts[-1])
    wlen = len(window)

    # Fast path: no copies at all (stored blocks, incompressible data)
    if not is_copy.any():
        return litlen.astype(np.uint8)

    tok_id = np.repeat(np.arange(ntok, dtype=np.int64), out_lens)
    j = np.arange(total, dtype=np.int64) - starts[tok_id]
    d = dist[tok_id].astype(np.int64)
    tok_start = starts[tok_id]

    # Extended index space: [0, wlen) = window bytes, [wlen, wlen+total) = out
    # immediate source for copy bytes (strictly before own token start):
    src = tok_start - d + np.where(d > 0, j % np.maximum(d, 1), 0)
    copy_byte = d > 0
    if int((src + wlen).min() if copy_byte.any() else 0) < 0:
        # check only copy bytes
        if ((src < -wlen) & copy_byte).any():
            raise DataError("invalid distance too far back")

    ptr = np.arange(wlen + total, dtype=np.int64)
    ptr[wlen:] = np.where(copy_byte, src + wlen, ptr[wlen:])

    vals = np.empty(wlen + total, dtype=np.uint8)
    vals[:wlen] = window
    np.putmask(vals[wlen:], ~copy_byte, litlen[tok_id].astype(np.uint8))

    # pointer doubling to roots
    span = 1
    while span < wlen + total:
        nxt = ptr[ptr]
        if np.array_equal(nxt, ptr):
            break
        ptr = nxt
        span <<= 1
    return vals[ptr[wlen:]]
