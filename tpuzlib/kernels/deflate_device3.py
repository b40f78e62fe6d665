"""Device deflate v3: sort-carried matching + shifted-compare screens +
sort-based histogram/pack.  One jit program encodes a whole batch of
chunks end-to-end (dynamic trees included) with zero host sync.

Design:

  * Match screens are chains of shifted compares over flat position
    arrays (a shift by d is a slice), with 16-byte verified prefixes so
    most matches never need the gather-based extension.  XLA fuses each
    screen's slices, compares and running max into one loop.
  * Large gathers/scatters are replaced with sorts:
      - sorted-domain -> position-domain return is a 2-op sort, not a
        scatter-max;
      - histograms are sort + boundary-compact, not scatter-adds;
      - the bit packer is a monotonic bucketed-OR: entry list -> sort by
        word index -> cumsum -> boundary-compact -> adjacent diff (token
        bit pieces within one word are disjoint, so sum == or).
  * Long matches resolve via the d-chain: a 16-byte screen that links to
    the same-distance screen 16 bytes ahead forms a segmented suffix
    scan (handles runs and any periodic data exactly); only chain-broken
    >=16 candidates use the gather-based extension, on a compacted list.
  * The batch is processed FLAT (B*(ctx+N) arrays, chunk id folded into
    sort keys) — fixed XLA op overheads amortize across the batch.

Capability parity: reference longest_match + deflate_slow drivers
(src/deflate.ts:827-946, :1054-1182), deftree build + send_all_trees
(src/deftree.ts:190-267, deflate.ts:378-443), bit packer
(deflate.ts:352-374).  Forced segment breaks every SEG=4096 positions
trade a little ratio for a data-parallel parse.
"""

from __future__ import annotations

import numpy as np

from ..codec.lz77 import LEVELS, TOO_FAR
from ..codec.tables import MAX_MATCH, MIN_MATCH, WINDOW_SIZE
from ..utils import trace as _trace
from .deflate_device import (
    CTX,
    SEG,
    _build_w32,
    segment_parse_xla,
    sym_fields_v2,
)

# per-level knobs: near-band depth, 4-byte probe depth, 6-byte probe depth
LEVELS_V3 = {
    1: dict(nd=8, k4=6, k6=0),
    2: dict(nd=8, k4=8, k6=0),
    3: dict(nd=12, k4=12, k6=0),
    4: dict(nd=16, k4=12, k6=0),
    5: dict(nd=16, k4=16, k6=0),
    6: dict(nd=24, k4=24, k6=8),
    7: dict(nd=24, k4=24, k6=8),
    8: dict(nd=32, k4=32, k6=16),
    9: dict(nd=32, k4=48, k6=24),
}


def _jnp():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _hash_k(jnp, w0, w1, nbytes, bits):
    C1 = jnp.uint32(0x9E3779B1)
    C2 = jnp.uint32(0x85EBCA77)
    if nbytes == 4:
        v = w0 * C1
    else:  # 6 bytes
        v = w0 * C1 + (w1 & jnp.uint32(0xFFFF)) * C2
    return ((v * C1) >> jnp.uint32(32 - bits)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# match screens: shifted 16-byte prefix compares over flat arrays
# ---------------------------------------------------------------------------


def _shift(jnp, x, d, fill):
    """y[p] = x[p - d], and ``fill`` where p < d."""
    return jnp.concatenate([jnp.full(d, fill, x.dtype), x[:-d]])


def _ctz_bytes(jnp, x):
    """Trailing zero BYTES of u32 (4 when x == 0)."""
    b0 = (x & jnp.uint32(0xFF)) != 0
    b1 = (x & jnp.uint32(0xFF00)) != 0
    b2 = (x & jnp.uint32(0xFF0000)) != 0
    return jnp.where(
        b0, 0, jnp.where(b1, 1, jnp.where(b2, 2, jnp.where(x != 0, 3, 4)))
    )


def _prefix16(jnp, a, b):
    """Common prefix bytes (0..16) of two 16-byte windows, each given as
    four u32 words (+0, +4, +8, +12 bytes)."""
    x0, x1, x2, x3 = (p ^ q for p, q in zip(a, b))
    return jnp.where(
        x0 != 0,
        _ctz_bytes(jnp, x0),
        jnp.where(
            x1 != 0,
            4 + _ctz_bytes(jnp, x1),
            jnp.where(
                x2 != 0, 8 + _ctz_bytes(jnp, x2), 12 + _ctz_bytes(jnp, x3)
            ),
        ),
    )


def _pack_key(jnp, screen, dist):
    """i32 best-match key: longer screen wins, then closer distance."""
    return (screen.astype(jnp.int32) << 16) | (
        jnp.int32(0xFFFF) - dist.astype(jnp.int32)
    )


def near_screen(jnp, w, mincand, lim16, nd):
    """Best 16-byte-screened match among distances 1..nd, per position.

    w: four flat (total,) u32 window-word arrays; mincand: lowest valid
    candidate position; lim16: per-position screen cap (0..16).
    Returns the packed key per position (0 = no match)."""
    total = w[0].shape[0]
    maxd = jnp.arange(total, dtype=jnp.int32) - mincand
    best = jnp.zeros(total, jnp.int32)
    for d in range(1, nd + 1):
        sc = jnp.minimum(
            _prefix16(jnp, w, [_shift(jnp, x, d, 0) for x in w]), lim16
        )
        ok = (d <= maxd) & (sc >= MIN_MATCH)
        best = jnp.maximum(
            best, jnp.where(ok, _pack_key(jnp, sc, jnp.int32(d)), 0)
        )
    return best


def far_screen(jnp, sh, sp, s, k):
    """Sorted-domain probe screen: for each row of the stable (hash, pos,
    window) sort, check the k previous rows — the k most recent same-hash
    predecessors, the sorted-domain image of a hash-chain walk (reference
    deflate.ts:860-941).  Candidate validity is encoded upstream as
    sentinel hashes, and screens are length-clipped afterwards in the
    position domain.  s: the four sorted window-word arrays.
    Returns the packed key per sorted row."""
    best = jnp.zeros(sh.shape[0], jnp.int32)
    for j in range(1, k + 1):
        d = sp - _shift(jnp, sp, j, -1)
        ok = (_shift(jnp, sh, j, -1) == sh) & (d >= 1) & (d <= WINDOW_SIZE)
        sc = _prefix16(jnp, s, [_shift(jnp, x, j, 0) for x in s])
        best = jnp.maximum(
            best, jnp.where(ok & (sc >= MIN_MATCH), _pack_key(jnp, sc, d), 0)
        )
    return best


def match_lengths_v3(jax, jnp, data, lim16, limit, mincand, chid, level):
    """Flat-batched match search over `total = B*(ctx+N)` positions.

    data: (total,) u8; lim16/limit: per-position caps (16 / MAX_MATCH);
    mincand: lowest valid candidate position per position; chid:
    per-position chunk id (static constant array).
    Returns (length, dist) int32 arrays over all positions."""
    params = LEVELS_V3[level]
    total = data.shape[0]
    w0 = _build_w32(jnp, data)
    w1 = jnp.concatenate([w0[4:], jnp.zeros(4, jnp.uint32)])
    w2 = jnp.concatenate([w0[8:], jnp.zeros(8, jnp.uint32)])
    w3 = jnp.concatenate([w0[12:], jnp.zeros(12, jnp.uint32)])
    pos = jnp.arange(total, dtype=jnp.int32)

    w = [w0, w1, w2, w3]
    best = near_screen(jnp, w, mincand, lim16, params["nd"])

    # invalid candidate positions (unfilled context) take a unique
    # sentinel hash: they can never match, so the probe sort needs no
    # validity operand and the far kernel no mincand/limit logic at all
    # (screens are length-clipped afterwards in the position domain)
    cand_ok = pos >= mincand
    SENT = jnp.int32(1 << 28)
    probes = [(4, params["k4"], 16)]
    if params["k6"]:
        probes.append((6, params["k6"], 18))
    for nbytes, k, bits in probes:
        h = _hash_k(jnp, w0, w1, nbytes, bits)
        hc = jnp.where(cand_ok, h | (chid << bits), SENT + pos)
        sh, sp, s0, s1, s2, s3 = jax.lax.sort(
            (hc, pos, w0, w1, w2, w3), num_keys=1, is_stable=True
        )
        fkeys = far_screen(jnp, sh, sp, [s0, s1, s2, s3], k)
        _, fpos = jax.lax.sort((sp, fkeys), num_keys=1, is_stable=True)
        best = jnp.maximum(best, fpos)

    sc = best >> 16
    sc = jnp.minimum(sc, lim16)
    d = jnp.where((best > 0) & (sc >= MIN_MATCH),
                  jnp.int32(0xFFFF) - (best & 0xFFFF), 0)
    sc = jnp.where(d > 0, sc, 0)

    # --- d-chain: segmented suffix scan over stride-16 links ------------
    d16 = jnp.concatenate([d[16:], jnp.zeros(16, jnp.int32)])
    ch16 = jnp.concatenate([chid[16:], jnp.full(16, -1, jnp.int32)])
    link = (sc >= 16) & (d > 0) & (d16 == d) & (ch16 == chid)

    # --- residual extension: >=16 screens whose chain breaks -----------
    # On text a few positions per thousand need this; on tables of
    # fixed-size binary records (vertex data) about one in eight do.
    # nonzero(size=) compacts the list without a full-array sort, and
    # the compare loop walks 16 B/step.  Overflowing the cap only
    # shortens those matches to their chain value (ratio, not
    # correctness).
    need = (sc >= 16) & (d > 0) & ~link & (limit > 16)
    ext_cap = max(1024, total // 4)
    # cap-overflow attribution: positions beyond ext_cap keep
    # their 16-byte chain value (shorter match, ratio-only).  With
    # TPUZLIB_TRACE_EXT=1 at program-build time the overflow count lands
    # in the trace counters so a ratio regression is attributable.
    import os as _os

    if _os.environ.get("TPUZLIB_TRACE_EXT") == "1":
        novf = jnp.maximum(
            jnp.sum(need.astype(jnp.int32)) - jnp.int32(ext_cap), 0
        )
        jax.debug.callback(
            lambda v: _trace.count("deflate.ext_cap_overflow", int(v)), novf
        )
    epos = jnp.nonzero(need, size=ext_cap, fill_value=total)[0].astype(
        jnp.int32
    )
    evalid = epos < total
    epos_c = jnp.where(evalid, epos, 0)
    edist = jnp.where(evalid, d[epos_c], 1)
    elim = jnp.where(evalid, limit[epos_c], 0)

    def cond(state):
        off, done, _ = state
        return jnp.logical_not(jnp.all(done))

    def _cz(jnp, x):
        """Trailing zero bytes of u32 (4 when x == 0)."""
        lsb = x & (jnp.uint32(0) - x)
        e = (
            jax.lax.bitcast_convert_type(lsb.astype(jnp.float32), jnp.uint32)
            >> jnp.uint32(23)
        ).astype(jnp.int32) - 127
        return jnp.where(x == 0, 4, e >> 3)

    def body(state):
        off, done, elen = state
        p = jnp.minimum(epos_c + off, total - 1)
        c = jnp.minimum(epos_c - edist + off, total - 1)
        x0 = w0[p] ^ w0[c]
        x1 = w1[p] ^ w1[c]
        x2 = w2[p] ^ w2[c]
        x3 = w3[p] ^ w3[c]
        pl16 = jnp.where(
            x0 != 0,
            _cz(jnp, x0),
            jnp.where(
                x1 != 0,
                4 + _cz(jnp, x1),
                jnp.where(
                    x2 != 0, 8 + _cz(jnp, x2), 12 + _cz(jnp, x3)
                ),
            ),
        )
        pl16 = jnp.clip(pl16, 0, elim - off)
        elen = jnp.where(done, elen, off + pl16)
        done = (
            done | (pl16 < 16) | (off + 16 >= elim) | (off + 16 > MAX_MATCH)
        )
        return off + 16, done, elen

    _, _, elen = jax.lax.while_loop(
        cond, body, (jnp.int32(16), ~evalid, jnp.zeros_like(epos_c) + 16)
    )
    elen = jnp.where(evalid, jnp.minimum(elen, jnp.minimum(elim, MAX_MATCH)), 16)
    # fold extension results back via one scatter over a small list
    base = jnp.where(sc >= 16, 16, sc).astype(jnp.int32)
    base = base.at[epos_c].max(jnp.where(evalid, elen, 0))

    # segmented suffix recurrence: ml[i] = base[i] + link[i] * ml[i+16].
    # The result is clipped to MAX_MATCH=258 and every linked step
    # contributes base >= 16, so 17 unrolled shift-steps saturate any
    # longer chain exactly (16 + 16*17 = 288 > 258), with no log-depth
    # strided scan.
    gi = link.astype(jnp.int32)
    ml = base
    for _ in range(17):
        ml16 = jnp.concatenate([ml[16:], jnp.zeros(16, jnp.int32)])
        ml = jnp.minimum(base + gi * ml16, MAX_MATCH)
    length = jnp.minimum(ml, jnp.minimum(limit, MAX_MATCH))
    length = jnp.where((d > 0) & (length >= MIN_MATCH), length, 0)
    length = jnp.where((length == MIN_MATCH) & (d > TOO_FAR), 0, length)
    return length, d


def _tokens_v3(jax, jnp, B, ctx, N, data, ctx_valids, n_valids, level):
    """Match + lazy + segment parse over the flat batch.

    data: (B, ctx+N) u8.  Returns (starts, litlen, dist) as (B, N)."""
    stride = ctx + N
    total = B * stride
    flat = data.reshape(total)
    li = jnp.arange(stride, dtype=jnp.int32)[None, :]
    cb = (jnp.arange(B, dtype=jnp.int32) * stride)[:, None]
    chid = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], (B, stride)
    ).reshape(total)
    ev2 = cb + ctx + n_valids[:, None]  # (B, 1) end_valid per chunk
    mincand = (cb + ctx - ctx_valids[:, None] + 0 * li).reshape(total)
    gpos2 = cb + li
    lim16 = jnp.clip(ev2 - gpos2, 0, 16).reshape(total)
    limit = jnp.clip(ev2 - gpos2, 0, MAX_MATCH).reshape(total)

    length, dist = match_lengths_v3(
        jax, jnp, flat, lim16, limit, mincand, chid, level
    )

    # new-position domain (B, N)
    length = length.reshape(B, stride)[:, ctx:]
    dist = dist.reshape(B, stride)[:, ctx:]

    eff = length
    if LEVELS[level].lazy:
        nxt = jnp.concatenate(
            [length[:, 1:], jnp.zeros((B, 1), jnp.int32)], axis=1
        )
        defer = (
            (eff >= MIN_MATCH) & (eff < LEVELS[level].max_lazy) & (nxt > eff)
        )
        eff = jnp.where(defer, 0, eff)

    t = jnp.arange(N, dtype=jnp.int32) % SEG
    room = SEG - t
    effT = jnp.minimum(eff, room[None, :])
    eff = jnp.where(effT >= MIN_MATCH, effT, 0)
    step = jnp.where(eff >= MIN_MATCH, eff, 1)

    flatN = B * N
    stepf = step.reshape(flatN)
    nvf = jnp.repeat(n_valids, N)
    localN = jnp.tile(jnp.arange(N, dtype=jnp.int32), B)
    # the parse treats the flat array as one stream; SEG divides N so
    # segment seeds align with chunk starts, and per-chunk n_valid
    # masking happens here (the parse's own n_valid is the full span)
    starts = segment_parse_xla(jax, jnp, stepf, flatN, seg=SEG)
    starts = starts & (localN < nvf)
    starts = starts.reshape(B, N)
    litlen = jnp.where(
        (starts & (eff >= MIN_MATCH)), eff, data[:, ctx:].astype(jnp.int32)
    )
    dists = jnp.where(starts & (eff >= MIN_MATCH), dist, 0)
    return starts, litlen, dists


# ---------------------------------------------------------------------------
# sort-based histogram
# ---------------------------------------------------------------------------

NGROUP = 320  # >= 287 possible lit symbols + sentinel, padded


def _hist_sorted(jax, jnp, B, skey, nbins, nsym_real):
    """Per-chunk bincount of pre-masked symbol keys.

    skey: (B, T) int32 = chunk*KSPAN + sym, with masked entries mapped to
    chunk*KSPAN + KSPAN-1 (sentinel; every chunk is guaranteed at least
    one sentinel entry, which bounds its last real group).  Returns
    (B, nbins) int32 counts.  KSPAN must exceed nsym_real+1."""
    T = skey.shape[1]
    n = B * T
    flat = jnp.sort(skey.reshape(n))
    i = jnp.arange(n, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.full(1, -1, jnp.int32), flat[:-1]])
    first = flat != prev
    gkey = jnp.where(first, i, n + i)
    BIGSYM = jnp.int32((1 << 14) - 1)
    _, gsym_s, gfirst_s = jax.lax.sort(
        (gkey, jnp.where(first, flat, BIGSYM), jnp.where(first, i, n)),
        num_keys=1,
        is_stable=True,
    )
    G = B * NGROUP
    gsym = gsym_s[:G]
    gfirst = gfirst_s[:G]
    gnextfirst = jnp.concatenate([gfirst_s[1 : G + 1]])
    counts = gnextfirst - gfirst
    chunk = gsym >> jnp.int32(10)
    sym = gsym & jnp.int32((1 << 10) - 1)
    okg = (gsym != BIGSYM) & (sym < nsym_real)
    out = jnp.zeros((B, nbins), jnp.int32)
    out = out.at[
        jnp.where(okg, jnp.minimum(chunk, B - 1), 0),
        jnp.where(okg, jnp.minimum(sym, nbins - 1), 0),
    ].add(jnp.where(okg, counts, 0))
    return out


# ---------------------------------------------------------------------------
# per-token fields: symbol decomposition + per-chunk code-table lookups
# ---------------------------------------------------------------------------


def pack_fields(jax, jnp, tok, lcodes, lbits, dcodes, dbits):
    """Token tape -> (lo u32, hi u32, nb i32) bit fields per token.

    tok: (B, T) u32 tokens (bits 0-8 litlen, bit 9 is-match, bits 10+
    distance-1; 511 is the pad sentinel, which emits nothing).
    lcodes/lbits: (B, 286) literal/length codes and lengths;
    dcodes/dbits: (B, 30) distance codes and lengths.  A token's bits
    are code | extra | dist code | dist extra, LSB first, split over two
    words (at most 15+5+15+13 = 48 bits)."""
    litlen = (tok & jnp.uint32(0x1FF)).astype(jnp.int32)
    is_match = ((tok >> jnp.uint32(9)) & 1) == 1
    dist = ((tok >> jnp.uint32(10)).astype(jnp.int32) + 1) * is_match
    lsym, lext, lext_val, dsym, dext, dext_val = sym_fields_v2(
        jax, jnp, litlen, dist, is_match
    )
    # symbols past the real tables (the 511 pad) look up zero-width codes
    lpad = ((0, 0), (0, 512 - lcodes.shape[1]))
    dpad = ((0, 0), (0, 32 - dcodes.shape[1]))
    lcode = jnp.take_along_axis(jnp.pad(lcodes, lpad), lsym, axis=1)
    nb = jnp.take_along_axis(jnp.pad(lbits, lpad), lsym, axis=1)
    dcode = jnp.take_along_axis(jnp.pad(dcodes, dpad), dsym, axis=1)
    dnb = jnp.take_along_axis(jnp.pad(dbits, dpad), dsym, axis=1)
    dcode = jnp.where(is_match, dcode, 0).astype(jnp.uint32)
    dnb = jnp.where(is_match, dnb, 0)

    def emit2(lo, hi, nb, val, bits):
        val = val.astype(jnp.uint32)
        shc = jnp.clip(nb, 0, 31).astype(jnp.uint32)
        in_lo = (jnp.where(nb < 32, val, 0) << shc).astype(jnp.uint32)
        spill = jnp.where(
            (nb > 0) & (nb < 32), val >> (jnp.uint32(32) - shc), 0
        )
        in_hi = jnp.where(
            nb >= 32, val << jnp.clip(nb - 32, 0, 31).astype(jnp.uint32), spill
        )
        return lo | in_lo, (hi | in_hi).astype(jnp.uint32), nb + bits

    lo = lcode.astype(jnp.uint32)
    hi = jnp.zeros_like(lo)
    lo, hi, nb = emit2(lo, hi, nb, lext_val, lext)
    lo, hi, nb = emit2(lo, hi, nb, dcode, dnb)
    lo, hi, nb = emit2(lo, hi, nb, dext_val, dext)
    return lo, hi, nb


# ---------------------------------------------------------------------------
# the full batched encoder
# ---------------------------------------------------------------------------


def make_encode_batch_v3(level: int, chunk: int, batch: int, out_words: int,
                         ctx: int = CTX):
    """encode(data u8[B, ctx+chunk], ctx_valid i32[B], n_valid i32[B],
    last i32[B]) -> (words u32[B, out_words], total_bits i32[B], ok i32[B])

    ok[b] == 0 when chunk b overflowed the token cap (caller re-encodes
    that chunk on host — happens only on pathological all-literal data,
    where a stored block is the right encoding anyway)."""
    jax, jnp = _jnp()
    from .huffman_device import (
        canonical_codes_device,
        package_merge_device,
    )
    from ..codec.tables import CLC_ORDER

    B, N = batch, chunk
    if B > 1 and N % SEG:
        # the flat parse seeds its segments every SEG positions; each
        # chunk must start on a seed
        raise ValueError(f"chunk {N} must be a multiple of {SEG} when batch > 1")
    # token cap: half the chunk, in whole 4096-token steps
    T_CAP = max(4096, (N // 2 // 4096) * 4096)
    HDRF = 338  # 3 + 19 + 316 header fields
    clc_order = np.asarray(CLC_ORDER)

    @jax.jit
    def encode(data, ctx_valids, n_valids, lasts):
        starts, litlen, dist = _tokens_v3(
            jax, jnp, B, ctx, N, data, ctx_valids, n_valids, level
        )

        # ---- compact tokens to (B, T_CAP) ------------------------------
        li = jnp.arange(N, dtype=jnp.int32)
        key = jnp.where(starts, li[None, :], N + li[None, :])
        key = key + (jnp.arange(B, dtype=jnp.int32) * (2 * N))[:, None]
        pay = (
            litlen.astype(jnp.uint32)
            | ((dist > 0).astype(jnp.uint32) << jnp.uint32(9))
            | (jnp.clip(dist - 1, 0, WINDOW_SIZE - 1).astype(jnp.uint32) << jnp.uint32(10))
        )
        skey, spay = jax.lax.sort(
            (key.reshape(B * N), pay.reshape(B * N)), num_keys=1, is_stable=True
        )
        tok = spay.reshape(B, N)[:, :T_CAP]
        M = jnp.sum(starts.astype(jnp.int32), axis=1)  # tokens per chunk
        ok = (M + 1 < T_CAP).astype(jnp.int32)
        # EOB (symbol 256, encoded as literal-field 256) + sentinel pads
        eob_at = jnp.minimum(M, T_CAP - 1)
        tok = tok.at[jnp.arange(B), eob_at].set(jnp.uint32(256))
        colt = jnp.arange(T_CAP, dtype=jnp.int32)[None, :]
        tok = jnp.where(colt > eob_at[:, None], jnp.uint32(511), tok)

        # ---- histograms (sort + boundary compact) ----------------------
        tlit = (tok & jnp.uint32(0x1FF)).astype(jnp.int32)
        tmatch = ((tok >> jnp.uint32(9)) & 1).astype(jnp.int32)
        tdist = ((tok >> jnp.uint32(10)).astype(jnp.int32) + 1) * tmatch
        lsym, _, _, dsym, _, _ = sym_fields_v2(
            jax, jnp, jnp.where(tmatch == 1, tlit, tlit), tdist, tmatch == 1
        )
        lsym = jnp.where(tlit == 511, 1023, lsym)  # sentinel
        KSPAN = 1 << 10
        cb = (jnp.arange(B, dtype=jnp.int32) * KSPAN)[:, None]
        lit_freq = _hist_sorted(
            jax, jnp, B, jnp.minimum(lsym, KSPAN - 1) + cb, 286, 286
        )
        dkey = jnp.where(tmatch == 1, dsym, KSPAN - 1)
        dist_freq = _hist_sorted(jax, jnp, B, dkey + cb, 30, 30)

        # ---- trees (batched package-merge) -----------------------------
        # one COMBINED (2B, 286) vmap on purpose: lit/dist trees at native
        # widths (two vmaps, dist at 30) do 45% less arithmetic but twice
        # the sequential small ops, and this stage is bound by op count,
        # not arithmetic.
        both = jnp.concatenate(
            [lit_freq, jnp.pad(dist_freq, ((0, 0), (0, 256)))], axis=0
        )  # (2B, 286)
        lens = jax.vmap(lambda f: package_merge_device(jax, jnp, f, 15))(both)
        ll = lens[:B]
        dl = lens[B:, :30]
        codes = jax.vmap(lambda l: canonical_codes_device(jax, jnp, l))(lens)
        lcodes = codes[:B]
        dcodes = codes[B:, :30]

        # ---- dynamic header fields with RLE (per chunk) ----------------
        # the code-length sequence is RLE'd with symbols 16/17/18 exactly
        # as reference deflate.ts scan_tree/send_tree (:267-312,:378-443):
        # runs never cross the lit/dist tree boundary.
        all_lengths = jnp.concatenate([ll, dl], axis=1)  # (B, 316)
        P = 316
        pidx = jnp.arange(P, dtype=jnp.int32)[None, :]
        prev = jnp.concatenate(
            [jnp.full((B, 1), -1, jnp.int32), all_lengths[:, :-1]], axis=1
        )
        change = (all_lengths != prev) | (pidx == 0) | (pidx == 286)
        run_start = jax.lax.cummax(jnp.where(change, pidx, -1), axis=1)
        nxt = jnp.flip(
            jax.lax.cummin(
                jnp.flip(jnp.where(change, pidx, P), axis=1), axis=1
            ),
            axis=1,
        )
        next_change = jnp.concatenate(
            [nxt[:, 1:], jnp.full((B, 1), P, jnp.int32)], axis=1
        )
        L = next_change - run_start
        j = pidx - run_start
        v = all_lengths
        # zero runs: k full 18x138 chunks, then 18/17/plain by remainder
        kz = L // 138
        rz = L % 138
        n18 = kz + (rz >= 11)
        is18 = (v == 0) & (j % 138 == 0) & (j // 138 < n18)
        size18 = jnp.minimum(138, L - j)
        is17 = (v == 0) & (rz >= 3) & (rz <= 10) & (j == kz * 138)
        isp0 = (v == 0) & (rz >= 1) & (rz <= 2) & (j >= kz * 138)
        # nonzero runs: first emits the value, rest covered by 16s
        m = L - 1
        k6 = m // 6
        r6 = m % 6
        n16 = k6 + (r6 >= 3)
        j1 = j - 1
        is16 = (v != 0) & (j >= 1) & (j1 % 6 == 0) & (j1 // 6 < n16)
        size16 = jnp.minimum(6, m - j1)
        ispv = (v != 0) & (
            (j == 0) | ((j >= 1) & (r6 >= 1) & (r6 <= 2) & (j1 >= k6 * 6))
        )
        emit = is18 | is17 | is16 | isp0 | ispv
        sym = jnp.where(
            is18, 18,
            jnp.where(is17, 17, jnp.where(is16, 16, jnp.where(isp0, 0, v))),
        )
        extra_bits = jnp.where(is18, 7, jnp.where(is17, 3, jnp.where(is16, 2, 0)))
        extra_val = jnp.where(
            is18, size18 - 11,
            jnp.where(is17, rz - 3, jnp.where(is16, size16 - 3, 0)),
        )

        cl_freq = jnp.zeros((B, 19), jnp.int32).at[
            jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, P)),
            jnp.where(emit, sym, 0),
        ].add(emit.astype(jnp.int32))
        cl_len = jax.vmap(lambda f: package_merge_device(jax, jnp, f, 7))(cl_freq)
        cl_codes = jax.vmap(lambda l: canonical_codes_device(jax, jnp, l))(cl_len)
        clo = jnp.asarray(clc_order)
        sym_c = jnp.where(emit, sym, 0)
        fbits = jnp.take_along_axis(cl_len, sym_c, axis=1)
        fcodes = jnp.take_along_axis(cl_codes, sym_c, axis=1)
        fval = fcodes | (
            extra_val.astype(jnp.uint32) << fbits.astype(jnp.uint32)
        )
        hdr_vals = jnp.concatenate(
            [
                jnp.broadcast_to(jnp.array([29, 29, 15], jnp.uint32), (B, 3)),
                cl_len[:, clo].astype(jnp.uint32),
                jnp.where(emit, fval, 0),
            ],
            axis=1,
        )  # (B, 338)
        hdr_bits = jnp.concatenate(
            [
                jnp.broadcast_to(jnp.array([5, 5, 4], jnp.int32), (B, 3)),
                jnp.broadcast_to(jnp.full((1, 19), 3, jnp.int32), (B, 19)),
                jnp.where(emit, fbits + extra_bits, 0),
            ],
            axis=1,
        )

        # ---- per-token fields -----------------------------------------
        lo_t, hi_t, nb_t = pack_fields(jax, jnp, tok, lcodes, ll, dcodes, dl)

        # ---- unified field stream: head3 | header | tokens -------------
        head3 = (jnp.uint32(4) | lasts.astype(jnp.uint32))[:, None]
        all_lo = jnp.concatenate([head3, hdr_vals, lo_t], axis=1)
        all_hi = jnp.concatenate(
            [jnp.zeros((B, 1 + HDRF), jnp.uint32), hi_t], axis=1
        )
        all_nb = jnp.concatenate(
            [jnp.full((B, 1), 3, jnp.int32), hdr_bits, nb_t], axis=1
        )
        offsets = jnp.cumsum(all_nb, axis=1) - all_nb
        total_bits = offsets[:, -1] + all_nb[:, -1]

        # ---- bucketed-OR bit pack (sort + cumsum + compact) ------------
        F = 1 + HDRF + T_CAP
        idx = (offsets >> 5).astype(jnp.int32)
        sh = (offsets & 31).astype(jnp.uint32)
        p0 = (all_lo << sh).astype(jnp.uint32)
        p1 = (
            jnp.where(sh > 0, all_lo >> (jnp.uint32(32) - sh), 0)
            | (all_hi << sh)
        ).astype(jnp.uint32)
        p2 = jnp.where(sh > 0, all_hi >> (jnp.uint32(32) - sh), jnp.uint32(0))
        wb = (jnp.arange(B, dtype=jnp.int32) * out_words)[:, None]
        # clip to the out_words window; idx for zero-width fields dedups
        e_idx = jnp.concatenate(
            [
                wb + jnp.minimum(idx, out_words - 1),
                wb + jnp.minimum(idx + 1, out_words - 1),
                wb + jnp.minimum(idx + 2, out_words - 1),
                wb + jnp.broadcast_to(
                    jnp.arange(out_words, dtype=jnp.int32)[None, :], (B, out_words)
                ),
            ],
            axis=1,
        ).reshape(-1)
        e_val = jnp.concatenate(
            [p0, p1, p2, jnp.zeros((B, out_words), jnp.uint32)], axis=1
        ).reshape(-1)
        sidx, sval = jax.lax.sort((e_idx, e_val), num_keys=1, is_stable=True)
        cum = jnp.cumsum(sval, dtype=jnp.uint32)
        n_e = e_idx.shape[0]
        nxt = jnp.concatenate([sidx[1:], jnp.full(1, -1, jnp.int32)])
        bound = sidx != nxt
        bkey = jnp.where(bound, jnp.arange(n_e, dtype=jnp.int32), n_e)
        _, bcum = jax.lax.sort((bkey, cum), num_keys=1, is_stable=True)
        wcum = bcum[: B * out_words]
        prev = jnp.concatenate([jnp.zeros(1, jnp.uint32), wcum[:-1]])
        words = (wcum - prev).reshape(B, out_words)

        ok = ok & (total_bits <= out_words * 32 - 64).astype(jnp.int32)
        return words, total_bits, ok

    return encode


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

_cache: dict = {}


def _get(key, builder):
    if key not in _cache:
        _cache[key] = builder()
    return _cache[key]


def deflate_device_v3(
    data: np.ndarray, level: int = 6, chunk: int = 1 << 18, batch: int = 8
):
    """Round-3 device deflate: the batched v3 encoder + host bit join.

    Returns raw DEFLATE bytes, or None when any chunk overflowed the
    token/output caps (pathological near-incompressible data — callers
    fall back to the host engine, which will choose stored blocks)."""
    import jax.numpy as jnp

    from ..codec.bitsink import BitSink
    from .deflate_device import _push_words

    n = len(data)
    nchunks = max(1, -(-n // chunk))
    batch = min(batch, nchunks)
    out_words = min(chunk + 4, (chunk * 10) // 32 + 64)
    enc = _get(
        ("enc3", level, chunk, batch, out_words),
        lambda: make_encode_batch_v3(level, chunk, batch, out_words),
    )

    sink = BitSink()
    results = []
    for g in range(0, nchunks, batch):
        group = list(range(g, min(g + batch, nchunks)))
        bufs = np.zeros((batch, CTX + chunk), dtype=np.uint8)
        cv = np.zeros(batch, dtype=np.int32)
        nv = np.zeros(batch, dtype=np.int32)
        lv = np.zeros(batch, dtype=np.int32)
        for bi, ci in enumerate(group):
            lo, hi = ci * chunk, min(ci * chunk + chunk, n)
            ctxb = data[max(0, lo - CTX) : lo]
            if len(ctxb):
                bufs[bi, CTX - len(ctxb) : CTX] = ctxb
            bufs[bi, CTX : CTX + hi - lo] = data[lo:hi]
            cv[bi] = len(ctxb)
            nv[bi] = hi - lo
            lv[bi] = 1 if ci == nchunks - 1 else 0
        results.append(
            (
                group,
                enc(jnp.asarray(bufs), jnp.asarray(cv), jnp.asarray(nv),
                    jnp.asarray(lv)),
            )
        )
    for group, (words, total_bits, ok) in results:
        words = np.asarray(words)
        total_bits = np.asarray(total_bits)
        okh = np.asarray(ok)
        for bi, ci in enumerate(group):
            lo, hi = ci * chunk, min(ci * chunk + chunk, n)
            nv_b = hi - lo
            nstored = max(1, -(-nv_b // 65535))
            stored_bits = 8 * nv_b + nstored * (3 + 32) + 8
            if okh[bi] and int(total_bits[bi]) <= stored_bits:
                _push_words(sink, words[bi], int(total_bits[bi]))
            else:
                # incompressible chunk: stored blocks beat any token tape
                # (reference _tr_flush_block stored choice, deflate.ts:648)
                _push_stored(sink, data[lo:hi], ci == nchunks - 1)
    out, _, _ = sink.flush(final=True)
    return out


def _push_stored(sink, chunk_bytes: np.ndarray, is_last: bool) -> None:
    """Emit byte-aligned stored blocks for one chunk."""
    nv = len(chunk_bytes)
    off = 0
    while True:
        blk = min(65535, nv - off)
        final = is_last and (off + blk == nv)
        sink.push_scalar(1 if final else 0, 1)
        sink.push_scalar(0, 2)
        sink.align_byte()
        sink.push_scalar(blk | ((~blk & 0xFFFF) << 16), 32)
        sink.push_bytes(np.asarray(chunk_bytes[off : off + blk]))
        off += blk
        if off >= nv:
            break


class DeviceDeflater:
    """Streaming deflate with DEVICE-RESIDENT codec state.

    The match window (last CTX bytes) lives on the device as a jax array
    and is carried across append() calls — the device analog of the
    reference's persistent window/hash state across deflate() calls
    (deflate.ts:110-194, infblocks suspend/resume contract
    SURVEY.md §5 checkpoint/resume).  Input is staged into fixed-size
    chunk buffers (static shapes; the reference's own fixed 16 KiB drain
    pattern, zstream.ts:11, scaled up); the only host state is the
    sub-byte bit remainder of the emitted stream.

    append(data) -> compressed bytes ready so far (byte-aligned slices);
    finish() -> final bytes (BFINAL block + padding).
    """

    def __init__(self, level: int = 6, chunk: int = 1 << 18, batch: int = 4):
        import jax.numpy as jnp

        from ..codec.bitsink import BitSink

        self.level = level
        self.chunk = chunk
        self.batch = batch
        self.out_words = min(chunk + 4, (chunk * 10) // 32 + 64)
        self._enc = _get(
            ("enc3", level, chunk, batch, self.out_words),
            lambda: make_encode_batch_v3(level, chunk, batch, self.out_words),
        )
        self._jnp = jnp
        self._ctx = jnp.zeros(CTX, jnp.uint8)  # device-resident window
        self._ctx_valid = 0
        self._pending = np.empty(0, np.uint8)
        self._sink = BitSink()
        self._finished = False

    def _encode_groups(self, chunks, lasts):
        """chunks: list of np arrays (each == self.chunk long except a
        final short one when finishing).  Returns nothing; pushes bits."""
        jnp = self._jnp
        from .deflate_device import _push_words

        i = 0
        while i < len(chunks):
            group = chunks[i : i + self.batch]
            glasts = lasts[i : i + self.batch]
            B = self.batch
            bufs = jnp.zeros((B, CTX + self.chunk), jnp.uint8)
            cv = np.zeros(B, np.int32)
            nv = np.zeros(B, np.int32)
            lv = np.zeros(B, np.int32)
            ctx = self._ctx
            ctx_valid = self._ctx_valid
            for bi, ch in enumerate(group):
                bufs = bufs.at[bi, :CTX].set(ctx)
                bufs = bufs.at[bi, CTX : CTX + len(ch)].set(jnp.asarray(ch))
                cv[bi] = ctx_valid
                nv[bi] = len(ch)
                lv[bi] = int(glasts[bi])
                # next chunk's context: tail of (ctx | data) on device
                row = bufs[bi, : CTX + len(ch)]
                ctx = row[-CTX:] if len(ch) >= CTX else jnp.concatenate(
                    [ctx[len(ch) :], jnp.asarray(ch)]
                )
                ctx_valid = min(CTX, ctx_valid + len(ch))
            words, total_bits, ok = self._enc(
                bufs, jnp.asarray(cv), jnp.asarray(nv), jnp.asarray(lv)
            )
            _trace.count("deflate.device", int(nv.sum()))
            self._ctx = ctx
            self._ctx_valid = ctx_valid
            wh = np.asarray(words)
            tb = np.asarray(total_bits)
            okh = np.asarray(ok)
            for bi, ch in enumerate(group):
                nv_b = len(ch)
                nstored = max(1, -(-nv_b // 65535))
                if okh[bi] and int(tb[bi]) <= 8 * nv_b + nstored * 40 + 8:
                    _push_words(self._sink, wh[bi], int(tb[bi]))
                else:
                    _push_stored(self._sink, ch, bool(glasts[bi]))
            i += self.batch

    def append(self, data) -> np.ndarray:
        if self._finished:
            raise RuntimeError("DeviceDeflater instances cannot be reused")
        from ..common import u8_view

        data = np.ascontiguousarray(u8_view(data))
        self._pending = (
            np.concatenate([self._pending, data]) if len(self._pending) else data
        )
        chunks = []
        while len(self._pending) > self.chunk:
            chunks.append(self._pending[: self.chunk])
            self._pending = self._pending[self.chunk :]
        if chunks:
            self._encode_groups(chunks, [0] * len(chunks))
        out, _, _ = self._sink.flush(final=False)
        return out

    def finish(self) -> np.ndarray:
        if self._finished:
            raise RuntimeError("DeviceDeflater instances cannot be reused")
        self._finished = True
        tailbuf = np.zeros(self.chunk, np.uint8)
        n = len(self._pending)
        tailbuf[:n] = self._pending
        # encode the (possibly empty) final chunk with n_valid masking
        jnp = self._jnp
        from .deflate_device import _push_words

        bufs = jnp.zeros((self.batch, CTX + self.chunk), jnp.uint8)
        bufs = bufs.at[0, :CTX].set(self._ctx)
        bufs = bufs.at[0, CTX : CTX + self.chunk].set(jnp.asarray(tailbuf))
        cv = np.zeros(self.batch, np.int32)
        nv = np.zeros(self.batch, np.int32)
        lv = np.zeros(self.batch, np.int32)
        cv[0] = self._ctx_valid
        nv[0] = n
        lv[0] = 1
        words, total_bits, ok = self._enc(
            bufs, jnp.asarray(cv), jnp.asarray(nv), jnp.asarray(lv)
        )
        _trace.count("deflate.device", n)
        okh = int(np.asarray(ok)[0])
        tb = int(np.asarray(total_bits)[0])
        nstored = max(1, -(-n // 65535))
        if okh and tb <= 8 * n + nstored * 40 + 8:
            _push_words(self._sink, np.asarray(words)[0], tb)
        else:
            _push_stored(self._sink, self._pending, True)
        self._pending = np.empty(0, np.uint8)
        out, _, _ = self._sink.flush(final=True)
        return out
