"""Vectorized LZ77 match search + greedy-lazy parse.

Redesign of the reference's serial hash-chain engine (src/deflate.ts:
hash insert :1079-1085, longest_match chain walk :827-946, deflate_fast
:953-1049, deflate_slow lazy matching :1054-1182).  Data-parallel structure:

 1. hash every position (multiplicative hash of the next 4/6/8 bytes);
 2. recover the K most recent same-bucket predecessors of every position
    with ONE stable sort (sorted by (bucket, position), the k-th previous
    in-bucket occurrence is simply the k-th previous row) — the
    data-parallel equivalent of walking a hash chain K deep.  Multiple
    probe lengths (4/6/8-byte hashes) replace deep chains for finding
    long matches;
 3. screen candidates with 8-byte window compares, fully extend only the
    best two, pick by (length, closeness);
 4. apply the zlib lazy-deferral rule *locally* (defer a match when the
    next position's match is longer) and extract the token sequence by
    pointer doubling — identical decisions to the serial greedy-lazy
    walk, computed in parallel.

All steps are (jnp-compatible) vectorized array ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .tables import MAX_MATCH, MIN_MATCH, WINDOW_SIZE
from .tokenize import byte_windows64

# Drop len-3 matches beyond this distance.  Stricter than the reference's
# TOO_FAR=4096 (deflate.ts:1102-1111): with dist > ~128 a length-3 match
# usually costs more bits than three literals, and a tight cap measurably
# improves text compression while keeping binary data parity.
TOO_FAR = 128


@dataclass(frozen=True)
class LevelParams:
    """Search-effort knobs per compression level.

    Capability parity with reference src/defconfig.ts:33-44 config_table;
    probes (hash_len -> K candidates) replace max_chain, `lazy` selects
    the deferral rule (levels 4-9 in zlib)."""

    probes: tuple  # ((hash_bytes, K), ...)
    lazy: bool
    max_lazy: int  # do not defer matches at least this long


LEVELS = {
    1: LevelParams(probes=((3, 2), (4, 4)), lazy=False, max_lazy=4),
    2: LevelParams(probes=((3, 2), (4, 8)), lazy=False, max_lazy=5),
    3: LevelParams(probes=((3, 3), (4, 16)), lazy=False, max_lazy=6),
    4: LevelParams(probes=((3, 3), (4, 8), (6, 4)), lazy=True, max_lazy=6),
    5: LevelParams(probes=((3, 3), (4, 12), (6, 6)), lazy=True, max_lazy=16),
    6: LevelParams(probes=((3, 4), (4, 20), (6, 8)), lazy=True, max_lazy=32),
    7: LevelParams(probes=((3, 4), (4, 28), (6, 12)), lazy=True, max_lazy=64),
    8: LevelParams(probes=((3, 6), (4, 48), (6, 24), (8, 12)), lazy=True, max_lazy=258),
    9: LevelParams(probes=((3, 8), (4, 96), (6, 48), (8, 24)), lazy=True, max_lazy=258),
}

_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


def _hash_positions(w64: np.ndarray, nbytes: int, bits: int) -> np.ndarray:
    """Multiplicative hash of the next `nbytes` bytes at every position."""
    if nbytes >= 8:
        v = w64
    else:
        v = w64 & ((np.uint64(1) << np.uint64(8 * nbytes)) - np.uint64(1))
    return ((v * _HASH_MULT) >> np.uint64(64 - bits)).astype(np.uint32)


def _candidates_from_sort(h: np.ndarray, k: int) -> np.ndarray:
    """(n, k) array: the k most recent earlier positions with equal hash
    (-1 where none).  One stable sort replaces per-position chain walks."""
    n = len(h)
    order = np.argsort(h, kind="stable").astype(np.int32)
    sh = h[order]
    cands = np.full((n, k), -1, dtype=np.int32)
    for j in range(1, k + 1):
        same = sh[j:] == sh[:-j]
        src = order[:-j]
        dst = order[j:]
        cands[dst[same], j - 1] = src[same]
    return cands


def _prefix_len_u64(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Common-prefix byte count (0..8) of two u64 little-endian windows."""
    v = x ^ y
    plen = np.zeros(len(v), dtype=np.int32)
    alive = np.ones(len(v), dtype=bool)
    for j in range(8):
        b = (v >> np.uint64(8 * j)) & np.uint64(0xFF)
        alive = alive & (b == 0)
        plen += alive
    return plen


def _extend_matches(
    data: np.ndarray,
    w64: np.ndarray,
    pos: np.ndarray,
    cand: np.ndarray,
    limit: np.ndarray,
) -> np.ndarray:
    """Exact match lengths for (pos, cand) pairs, capped by `limit`."""
    n = len(pos)
    length = np.zeros(n, dtype=np.int32)
    active = cand >= 0
    offset = np.zeros(n, dtype=np.int32)
    while active.any():
        ai = np.flatnonzero(active)
        p = pos[ai] + offset[ai]
        c = cand[ai] + offset[ai]
        pl = _prefix_len_u64(w64[p], w64[c])
        pl = np.minimum(pl, limit[ai] - offset[ai])
        length[ai] = offset[ai] + pl
        cont = (pl == 8) & (offset[ai] + 8 < limit[ai])
        offset[ai] += 8
        nxt = np.zeros(n, dtype=bool)
        nxt[ai[cont]] = True
        active = nxt
    return np.minimum(length, limit)


def find_matches(
    data: np.ndarray, ctx_len: int, params: LevelParams
) -> tuple[np.ndarray, np.ndarray]:
    """Best (length, distance) per position of data[ctx_len:].

    data = [window context | new bytes]; matches may start inside the
    context (the preset-dictionary mechanism of deflate.ts:1184-1216,
    generalized to chunk halos)."""
    n = len(data)
    nnew = n - ctx_len
    if nnew <= 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    w64 = byte_windows64(data)
    pos = np.arange(ctx_len, n, dtype=np.int32)
    limit = np.minimum(n - pos, MAX_MATCH).astype(np.int32)

    best_len = np.zeros(nnew, dtype=np.int32)
    best_cand = np.full(nnew, -1, dtype=np.int32)
    second_cand = np.full(nnew, -1, dtype=np.int32)
    best_screen = np.zeros(nnew, dtype=np.int32)

    for hash_bytes, k in params.probes:
        bits = 16 if hash_bytes == 4 else 18
        h = _hash_positions(w64, hash_bytes, bits)
        cands = _candidates_from_sort(h, k)[ctx_len:]
        for j in range(cands.shape[1]):
            c = cands[:, j]
            ok = (c >= 0) & (pos - c <= WINDOW_SIZE)
            cc = np.where(ok, c, 0)
            screen = _prefix_len_u64(w64[pos], w64[cc])
            screen = np.where(ok, np.minimum(screen, limit), -1)
            better = screen > best_screen
            # keep the displaced best as runner-up
            second_cand = np.where(better, best_cand, second_cand)
            best_cand = np.where(better, cc, best_cand)
            best_screen = np.where(better, screen, best_screen)

    # fully extend the best and runner-up, keep the longer (tie: closer)
    len1 = _extend_matches(data, w64, pos, best_cand, limit)
    len2 = _extend_matches(data, w64, pos, second_cand, limit)
    use2 = len2 > len1
    cand = np.where(use2, second_cand, best_cand)
    length = np.where(use2, len2, len1)
    dist = np.where(cand >= 0, pos - cand, 0).astype(np.int32)

    # legality + worthwhileness
    length = np.where(length >= MIN_MATCH, length, 0)
    length = np.where((length == MIN_MATCH) & (dist > TOO_FAR), 0, length)
    length = np.where(dist > 0, length, 0)
    return length.astype(np.int32), dist


def lazy_parse(
    length: np.ndarray, dist: np.ndarray, params: LevelParams
) -> np.ndarray:
    """Token starts via greedy(-lazy) parse; returns boolean take-match.

    Replicates the decision sequence of deflate_fast (:953-1049) /
    deflate_slow (:1054-1182): at a match position, deflate_slow emits a
    literal instead when the *next* position holds a strictly longer
    match (unless the current one is already >= max_lazy)."""
    n = len(length)
    eff = length.copy()
    if params.lazy and n > 1:
        nxt_len = np.concatenate([length[1:], np.zeros(1, np.int32)])
        defer = (eff >= MIN_MATCH) & (eff < params.max_lazy) & (nxt_len > eff)
        eff = np.where(defer, 0, eff)
    step = np.where(eff >= MIN_MATCH, eff, 1).astype(np.int64)

    # pointer-doubling walk from position 0 marks the token starts
    nxt = np.minimum(np.arange(n, dtype=np.int64) + step, n)
    J = np.concatenate([nxt, [np.int64(n)]])
    reach = np.zeros(n + 1, dtype=bool)
    reach[0] = True
    Jk = J
    steps = 1
    while steps < n + 1:
        newly = Jk[np.flatnonzero(reach)]
        before = reach[newly]
        reach[newly] = True
        if not (~before).any():
            break
        Jk = Jk[Jk]
        steps <<= 1
    starts = reach[:n]
    take_match = starts & (eff >= MIN_MATCH)
    return starts, take_match, eff


def tokenize_chunk(
    data: np.ndarray, ctx_len: int, level: int
) -> tuple[np.ndarray, np.ndarray]:
    """Full chunk -> token tape (litlen, dist) with zlib-compatible
    semantics.  data[:ctx_len] is window context only.

    Dispatches to the native hash-chain matcher when available (same
    token-tape contract); the vectorized path below is the algorithmic
    reference and the template for the device kernel."""
    try:
        from ..native.bindings import native_available

        if native_available():
            from ..native import api as native_api

            return native_api.tokenize(data, ctx_len, level)
    except Exception:  # pragma: no cover
        pass
    params = LEVELS[level]
    length, dist = find_matches(data, ctx_len, params)
    if len(length) == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    starts, take_match, eff = lazy_parse(length, dist, params)
    idx = np.flatnonzero(starts)
    lit_vals = data[ctx_len:][idx].astype(np.int32)
    tm = take_match[idx]
    litlen = np.where(tm, eff[idx], lit_vals)
    dists = np.where(tm, dist[idx], 0)
    return litlen.astype(np.int32), dists.astype(np.int32)
