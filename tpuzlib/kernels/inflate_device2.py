"""Device inflate v2: cursor-parallel speculative tokenizer.

Decoding a candidate token at every bit position costs ~24 gathers per
compressed byte; v2 instead:

  * K cursors start at evenly spaced bit offsets inside each block and
    decode symbols serially-in-lockstep (one lax.while_loop, 5 gathers
    per SYMBOL across all cursors — ~20x less gather traffic than
    per-bit decoding);
  * mis-aligned cursors self-synchronize onto the true symbol chain
    (rapidgzip-style speculation, PAPERS.md); splicing validates that
    each cursor's end position appears in the next cursor's visited set
    and drops the garbage prefix;
  * the whole multi-cursor tokenize is ONE device dispatch per block
    group — the host only parses block headers (it must discover them
    anyway) and splices tapes.

Capability parity: the throughput path of reference src/infcodes.ts
inflate_fast (:62-301); the host engine remains the byte-granular
streaming implementation and the fallback for mis-speculated gaps.
"""

from __future__ import annotations

import functools

import numpy as np

from ..codec import tokenize as tk
from ..codec.huffman import fixed_dist_lut, fixed_litlen_lut

LUT_MASK = 0x7FFF
NB_SHIFT, NB_MASK = 15, 0xF
EB_SHIFT = 19
IS_LEN_BIT = 1 << 23
IS_EOB_BIT = 1 << 24
INVALID_BIT = 1 << 31

ST_RUN, ST_STRIDE_END, ST_EOB, ST_ERR, ST_OOB = 0, 1, 2, 3, 4


class RepairCapExceeded(Exception):
    """Splice repair exceeded its bridge/row-pull budget (verdict r5 #8):
    the caller takes the single full host fallback instead."""


def _jnp():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _build_w32(jnp, data):
    n = data.shape[0]
    padded = jnp.concatenate([data, jnp.zeros(8, dtype=jnp.uint8)]).astype(jnp.uint32)
    w = padded[:n]
    w = w | (padded[1 : 1 + n] << jnp.uint32(8))
    w = w | (padded[2 : 2 + n] << jnp.uint32(16))
    w = w | (padded[3 : 3 + n] << jnp.uint32(24))
    return w


def cursor_tokenize_body(
    jax, jnp, CAP, w32, starts, stops, block_of, luts_lit, luts_dist,
    avail_bits, expect_eob=None,
):
    """Core K-cursor decode loop (shared by the jitted single-device
    wrapper and the shard_map sharded-inflate step).

    Spurious-EOB continuation (round 5): only expect_eob (block-last)
    cursors stop at an EOB symbol; any other cursor decoding one is in
    its speculation garbage (or an early-ended block, which the splice
    detects via eob_idx and routes to the repair), so it records a
    FLAGGED tape token (pack bit 26) and keeps decoding — the boundary
    chain no longer breaks on garbage EOBs.

    Returns (tok_pack u32[K*CAP], tok_bp i32[K*CAP], cnt i32[K],
    end_pos i32[K], status i32[K], eob_idx i32[K]); K = starts.shape[0];
    eob_idx = tape index of the cursor's first flagged EOB token (-1 if
    none)."""
    K = starts.shape[0]
    if expect_eob is None:
        expect_eob = jnp.ones(K, bool)

    def window_at(w32, bitpos):
        return w32[jnp.clip(bitpos >> 3, 0, w32.shape[0] - 1)] >> (
            (bitpos & 7).astype(jnp.uint32)
        )

    if True:
        k_idx = jnp.arange(K, dtype=jnp.int32)
        lut_base = block_of * 32768

        def cond(state):
            pos, cnt, status, _, _, _ = state
            return jnp.any(status == ST_RUN)

        def body(state):
            pos, cnt, status, tok_pack, tok_bp, eob_first = state
            run = status == ST_RUN
            w = window_at(w32, pos)
            ent = luts_lit[jnp.clip(lut_base + (w & jnp.uint32(LUT_MASK)).astype(jnp.int32), 0, luts_lit.shape[0] - 1)]
            nb = ((ent >> jnp.uint32(NB_SHIFT)) & jnp.uint32(NB_MASK)).astype(jnp.int32)
            eb = ((ent >> jnp.uint32(EB_SHIFT)) & jnp.uint32(NB_MASK)).astype(jnp.int32)
            base = (ent & jnp.uint32(LUT_MASK)).astype(jnp.int32)
            extra = (
                (w >> nb.astype(jnp.uint32))
                & ((jnp.uint32(1) << eb.astype(jnp.uint32)) - jnp.uint32(1))
            ).astype(jnp.int32)
            val = base + extra
            jump1 = nb + eb
            is_len = (ent & jnp.uint32(IS_LEN_BIT)) != 0
            is_eob = (ent & jnp.uint32(IS_EOB_BIT)) != 0
            bad = (ent >> jnp.uint32(31)) != 0

            w2 = window_at(w32, pos + jump1)
            dent = luts_dist[jnp.clip(lut_base + (w2 & jnp.uint32(LUT_MASK)).astype(jnp.int32), 0, luts_dist.shape[0] - 1)]
            dnb = ((dent >> jnp.uint32(NB_SHIFT)) & jnp.uint32(NB_MASK)).astype(jnp.int32)
            deb = ((dent >> jnp.uint32(EB_SHIFT)) & jnp.uint32(NB_MASK)).astype(jnp.int32)
            dbase = (dent & jnp.uint32(LUT_MASK)).astype(jnp.int32)
            w3 = window_at(w32, pos + jump1 + dnb)
            dextra = (
                w3 & ((jnp.uint32(1) << deb.astype(jnp.uint32)) - jnp.uint32(1))
            ).astype(jnp.int32)
            dval = dbase + dextra
            bad = bad | (is_len & ((dent >> jnp.uint32(31)) != 0))

            jump = jnp.where(is_len, jump1 + dnb + deb, jump1)
            nxt = pos + jump
            oob = nxt > avail_bits

            real_eob = is_eob & expect_eob
            is_data = run & ~bad & ~real_eob & ~oob
            # write the token (masked scatter: inactive lanes write to a
            # scratch slot at the end)
            slot = jnp.where(
                is_data & (cnt < CAP), k_idx * CAP + cnt, K * CAP
            )
            pack = (
                jnp.where(is_len, val, val).astype(jnp.uint32)
                | (jnp.where(is_len, dval, 0).astype(jnp.uint32) << jnp.uint32(9))
                | (is_len.astype(jnp.uint32) << jnp.uint32(25))
            )
            pack = jnp.where(is_eob, jnp.uint32(1 << 26), pack)
            tok_pack = tok_pack.at[slot].set(jnp.where(is_data, pack, 0))
            tok_bp = tok_bp.at[slot].set(jnp.where(is_data, pos, 0))

            eob_first = jnp.where(
                is_data & is_eob & (eob_first < 0) & (cnt < CAP),
                cnt, eob_first,
            )
            overflow = is_data & (cnt >= CAP)
            cnt = cnt + is_data.astype(jnp.int32)
            pos = jnp.where(is_data, nxt, pos)
            status = jnp.where(
                run & bad, ST_ERR,
                jnp.where(
                    run & ~bad & oob, ST_OOB,
                    jnp.where(
                        run & real_eob, ST_EOB,
                        jnp.where(run & overflow, ST_ERR, status),
                    ),
                ),
            )
            # EOB consumes its bits; stride end: next symbol starts
            # at/after stop
            pos = jnp.where(run & real_eob & ~bad & ~oob, pos + jump, pos)
            status = jnp.where(
                (status == ST_RUN) & (pos >= stops), ST_STRIDE_END, status
            )
            return pos, cnt, status, tok_pack, tok_bp, eob_first

        pos0 = jnp.where(starts >= 0, starts, 0)
        status0 = jnp.where(starts >= 0, ST_RUN, ST_STRIDE_END)
        status0 = jnp.where(
            (starts >= 0) & (starts >= stops), ST_STRIDE_END, status0
        )
        # derive the token-array carries from a (possibly device-varying)
        # input so their sharding variance matches the loop outputs under
        # shard_map
        zero_like_in = starts[0] * 0
        tok_pack0 = jnp.zeros(K * CAP + 1, jnp.uint32) + zero_like_in.astype(
            jnp.uint32
        )
        # unused slots hold a +inf sentinel so per-cursor rows stay
        # ascending for the splice searchsorted
        tok_bp0 = jnp.full(K * CAP + 1, 1 << 30, jnp.int32) + zero_like_in
        pos, cnt, status, tok_pack, tok_bp, eob_first = jax.lax.while_loop(
            cond,
            body,
            (pos0, jnp.zeros(K, jnp.int32) + zero_like_in, status0,
             tok_pack0, tok_bp0,
             jnp.full(K, -1, jnp.int32) + zero_like_in),
        )
        return tok_pack[:-1], tok_bp[:-1], cnt, pos, status, eob_first


@functools.lru_cache()
def make_cursor_tokenize(K: int, CAP: int):
    """Jitted single-device K-cursor tokenizer (see cursor_tokenize_body).

    Cursors with starts<0 are inactive padding."""
    jax, jnp = _jnp()

    @jax.jit
    def tok(w32, starts, stops, block_of, luts_lit, luts_dist, avail_bits,
            expect_eob):
        return cursor_tokenize_body(
            jax, jnp, CAP, w32, starts, stops, block_of,
            luts_lit, luts_dist, avail_bits, expect_eob,
        )

    return tok


@functools.lru_cache(maxsize=16)
def _make_sharded_tokenize(mesh, CAP: int):
    """Jitted K-cursor tokenizer as a shard_map over the mesh's "shards"
    axis: cursors split across devices, the stream and LUTs replicated."""
    jax, jnp = _jnp()
    from jax.sharding import PartitionSpec as P

    def shard_step(w32, st, sp, b, ll, ld, avail_bits, exp):
        return cursor_tokenize_body(
            jax, jnp, CAP, w32, st, sp, b, ll, ld, avail_bits, exp
        )

    return jax.jit(
        jax.shard_map(
            shard_step,
            mesh=mesh,
            in_specs=(P(), P("shards"), P("shards"), P("shards"),
                      P(), P(), P(), P("shards")),
            out_specs=(P("shards"),) * 6,
            check_vma=False,
        )
    )


@functools.lru_cache()
def stored_lut() -> np.ndarray:
    """Transparent LUT: decodes 8 raw bits as a literal byte.

    Stored-block data is byte-aligned (infblocks.ts:243-333), so a
    cursor whose lit-LUT is this table tokenizes a stored block's bytes
    as literals with the SAME decode loop as Huffman blocks — stored
    regions become just another cursor region, no host fallback."""
    i = np.arange(32768, dtype=np.uint32)
    return ((i & 0xFF) | (8 << NB_SHIFT)).astype(np.uint32)


def _parse_gap(buf: np.ndarray, bit: int, avail_bits: int):
    """Parse zero or more EMPTY stored blocks (sync-flush markers) from
    `bit`.  Returns (next_bit, final) where final=True when a BFINAL
    marker ended the stream, or None if the gap contains anything else."""
    final = False
    while True:
        reader = tk.BitReader(buf, bit, avail_bits)
        try:
            last = reader.bits(1)
            btype = reader.bits(2)
            if btype != 0:
                return bit, final
            reader.align_byte()
            length = reader.bits(16)
            nlen = reader.bits(16)
            if length != (~nlen & 0xFFFF):
                return None
            if length != 0:
                # non-empty stored block: not a sync marker — the block
                # planner decodes it via the transparent LUT
                return bit, final
            bit = reader.pos
            if last:
                return bit, True
        except (tk.DataError, tk.NeedMoreInput):
            return None


def _walk_gap(buf: np.ndarray, bit: int, avail_bits: int,
              stop_at: int | None = None):
    """Walk a run of sync markers AND non-empty stored blocks from `bit`.

    Returns (next_bit, final, ranges) where ranges is a list of
    (byte_start, length) for the stored payloads crossed, next_bit is
    the first non-type-0 header (or the end-of-walk position when
    final), or None on malformed data.  This is how inter-block stored
    runs — invisible to speculative discovery — get decoded: the host
    splices their bytes into the token tape as literals
    (reference inline handling: infblocks.ts:243-333)."""
    ranges = []
    while True:
        if stop_at is not None and bit == stop_at:
            return bit, False, ranges
        reader = tk.BitReader(buf, bit, avail_bits)
        try:
            last = reader.bits(1)
            btype = reader.bits(2)
            if btype != 0:
                return bit, False, ranges
            reader.align_byte()
            length = reader.bits(16)
            nlen = reader.bits(16)
            if length != (~nlen & 0xFFFF):
                return None
            byte_pos = reader.pos >> 3
            if byte_pos + length > len(buf):
                return None
            if length:
                ranges.append((byte_pos, length))
            bit = (byte_pos + length) * 8
            if last:
                return bit, True, ranges
        except (tk.DataError, tk.NeedMoreInput):
            return None


def _plan_blocks(buf: np.ndarray):
    """Host pass 1: discover block headers and build per-block LUTs.

    Returns a list of [header_bit, data_start_bit, stop_bit, luts,
    bfinal, open_end, is_stored, lens_info].  stop_bit is the position
    of the NEXT discovered header (the block's symbols must end at or
    before it, with only empty-stored sync markers in between).
    open_end=True means discovery could not see past this block — the
    caller decodes the remainder with the host engine from this block's
    actual end.

    Header discovery is ONE vectorized full-stream pass
    (speculative.find_all_block_starts) consumed via bisect instead of a
    window scan per block."""
    import bisect

    from ..parallel.speculative import find_all_block_starts

    headers = None  # computed lazily: single-block streams never need it
    avail_bits = len(buf) * 8
    blocks = []
    bit = 0
    while True:
        gap = _parse_gap(buf, bit, avail_bits)
        if gap is None:
            return blocks or None
        bit, final = gap
        if final:
            break
        header_bit = bit
        reader = tk.BitReader(buf, bit, avail_bits)
        try:
            last = reader.bits(1)
            btype = reader.bits(2)
            if btype == 0:
                # non-empty stored block: bytes decode via the
                # transparent LUT; the next header position is exact
                reader.align_byte()
                length = reader.bits(16)
                nlen = reader.bits(16)
                if length != (~nlen & 0xFFFF):
                    return blocks or None
                data_start = reader.pos
                end = data_start + 8 * length
                if end > avail_bits:
                    return blocks or None
                blocks.append(
                    [header_bit, data_start, end,
                     (stored_lut(), np.zeros(32768, np.uint32)),
                     bool(last), False, True, ("stored",)]
                )
                if last:
                    break
                bit = end
                continue
            if btype == 1:
                luts = (fixed_litlen_lut(), fixed_dist_lut())
                lens_info = ("fixed",)
            elif btype == 2:
                ll, ld, litlens, distlens = tk.parse_dynamic_header(
                    reader, return_lengths=True
                )
                luts = (ll, ld)
                lens_info = ("dyn", litlens, distlens)
            else:
                return blocks or None
        except (tk.DataError, tk.NeedMoreInput):
            return blocks or None
        data_start = reader.pos
        if last:
            blocks.append(
                [header_bit, data_start, avail_bits, luts, True, False,
                 False, lens_info]
            )
            break
        # find the next dynamic header (final ones included — the block
        # planner, unlike segment decoding, handles BFINAL blocks) from
        # the one-pass full-stream header list
        if headers is None:
            headers = find_all_block_starts(
                buf, from_bit=(data_start >> 3) * 8, allow_final=True
            )
        hi = bisect.bisect_right(headers, data_start)
        nxt = headers[hi] if hi < len(headers) else None
        if nxt is None or nxt <= data_start:
            blocks.append(
                [header_bit, data_start, avail_bits, luts, False, True,
                 False, lens_info]
            )
            break
        blocks.append(
            [header_bit, data_start, nxt, luts, False, False, False,
             lens_info]
        )
        bit = nxt
    return blocks or None


C0 = 192  # boundary-intersection candidates (overlap_bits / min sym bits)


@functools.lru_cache()
def make_splice_compact(K: int, CAP: int):
    """Jitted device splice + compaction (overlap-intersection).

    Cursors decode OVERLAP bits past their stop, so consecutive cursors'
    chains share positions once the speculative one self-synchronizes.
    Per boundary k -> k+1 the FIRST common symbol-start position at or
    after stop_k becomes the cut; cursor k keeps tokens before the cut,
    cursor k+1 from it.  An induction from each block's anchored first
    cursor proves every kept token is on the true chain.

    Returns (ok i32, M i32, comp u32[K*CAP], kcnt i32[K], diag) where
    diag = (jstop, any_common, first_c, jentry_next, bp0, bp_cut), the
    per-cursor vectors the HOST repair path (_repair_splice) needs when
    ok == 0 — speculation can mis-sync or decode a spurious EOB in its
    garbage prefix (probability ~2^-13 per garbage symbol, so large
    streams with thousands of cursors hit it routinely), and the repair
    re-decodes only the broken spans on the host instead of abandoning
    the whole stream."""
    jax, jnp = _jnp()

    @jax.jit
    def splice(tok_pack, tok_bp, cnt, end_pos, status, stops,
               block_starts, is_block_first, is_block_last, expect_eob,
               active, eob_idx):
        bp2 = tok_bp.reshape(K, CAP)
        # candidate cut positions: cursor k's recorded starts >= stop_k
        jstop = jax.vmap(jnp.searchsorted)(bp2, stops).astype(jnp.int32)
        cand_idx = jnp.minimum(jstop[:, None] + jnp.arange(C0)[None, :], CAP - 1)
        cand = jnp.take_along_axis(bp2, cand_idx, axis=1)  # (K, C0)
        cand_valid = (jstop[:, None] + jnp.arange(C0)[None, :]) < cnt[:, None]

        # membership of k's candidates in k+1's row
        bp_next = jnp.concatenate([bp2[1:], jnp.full((1, CAP), 1 << 30, jnp.int32)])
        cnt_next = jnp.concatenate([cnt[1:], jnp.zeros(1, jnp.int32)])
        mloc = jax.vmap(jnp.searchsorted)(bp_next, cand).astype(jnp.int32)  # (K, C0)
        mhit = jnp.take_along_axis(bp_next, jnp.minimum(mloc, CAP - 1), axis=1)
        common = (
            cand_valid
            & (mloc < cnt_next[:, None])
            & (mhit == cand)
        )
        # early in-block EOB: the block really ended before this cursor's
        # planned span (an undiscoverable stored run follows — the host
        # walks it, infblocks.ts:243-333 semantics).  Cursors after the
        # first EOB within a block decoded garbage: drop them entirely.
        eobf = active & (status == ST_EOB)
        c = jnp.cumsum(eobf.astype(jnp.int32))
        base = jax.lax.cummax(
            jnp.where(is_block_first, c - eobf.astype(jnp.int32), 0)
        )
        garbage = active & ((c - eobf.astype(jnp.int32) - base) > 0)
        efflast = ~garbage & (eobf | is_block_last)

        # boundary k -> k+1 exists only within a block, between live
        # cursors (an efflast cursor keeps everything it decoded)
        next_first = jnp.concatenate([is_block_first[1:], jnp.ones(1, bool)])
        boundary = active & ~garbage & ~efflast & ~next_first
        any_common = jnp.any(common, axis=1)
        first_c = jnp.argmax(common, axis=1).astype(jnp.int32)
        jcut = jnp.where(
            boundary & any_common,
            jstop + first_c,
            cnt,  # effective block-last cursors keep everything
        )
        jentry_next = jnp.take_along_axis(
            mloc, first_c[:, None], axis=1
        )[:, 0]
        # entry index per cursor: 0 when anchored at its block's start,
        # else the boundary's position in ITS row
        prev_entry = jnp.concatenate([jnp.zeros(1, jnp.int32), jentry_next[:-1]])
        prev_boundary_ok = jnp.concatenate(
            [jnp.ones(1, bool), (boundary & any_common)[:-1]]
        )
        jlo = jnp.where(is_block_first, 0, prev_entry)

        anchored = is_block_first & (
            (cnt == 0)
            | (
                jnp.take_along_axis(bp2, jnp.zeros((K, 1), jnp.int32), axis=1)[:, 0]
                == block_starts
            )
        )
        good_status = (
            garbage
            | eobf
            | ((status == ST_STRIDE_END) & ~(is_block_last & expect_eob))
        )
        keep_lo = jnp.where(active & ~garbage, jlo, CAP)
        keep_hi = jnp.where(active & ~garbage, jnp.minimum(jcut, cnt), 0)
        # a KEPT flagged-EOB token means the block really ended inside a
        # non-last cursor's span (early EOB / hidden stored run): the
        # fast path must decline (ok=0) so the host repair cuts at the
        # flag and bridges to the true block end — 'never silently keep
        # garbage tokens'
        kept_eob = (
            active & ~garbage & (eob_idx >= 0)
            & (eob_idx >= keep_lo) & (eob_idx < keep_hi)
        )
        ok = jnp.all(
            (
                good_status
                & (anchored | (~is_block_first & prev_boundary_ok) | garbage)
                & (~boundary | any_common)
                & ~kept_eob
            )
            | ~active
        )
        M, comp, kcnt = _compact_bounds(jax, jnp, K, CAP, tok_pack,
                                        keep_lo, keep_hi)
        bp0 = jnp.take_along_axis(
            bp2, jnp.zeros((K, 1), jnp.int32), axis=1
        )[:, 0]
        bp_cut = jnp.take_along_axis(
            bp2, jnp.minimum(jstop, CAP - 1)[:, None], axis=1
        )[:, 0]
        # ALL host-consumed vectors in ONE array, so the host pays one
        # device-to-host transfer instead of ~10 — layout: [ok, M] ++ 10
        # vectors at stride K (META_* indices below)
        meta = jnp.concatenate(
            [
                jnp.stack([ok.astype(jnp.int32), M]),
                cnt, end_pos, status, jstop,
                any_common.astype(jnp.int32), first_c, jentry_next,
                bp0, bp_cut, kcnt, eob_idx,
            ]
        )
        return meta, comp, kcnt

    return splice


# meta vector layout (make_splice_compact): meta[0]=ok, meta[1]=M, then
# vector i of K entries at [2+i*K : 2+(i+1)*K]
META_CNT, META_END, META_ST, META_JSTOP, META_ANYC = 0, 1, 2, 3, 4
META_FIRSTC, META_JENTRY, META_BP0, META_BPCUT, META_KCNT = 5, 6, 7, 8, 9
META_EOB = 10


def _meta_vec(meta_np: np.ndarray, K: int, i: int) -> np.ndarray:
    return meta_np[2 + i * K : 2 + (i + 1) * K]


def _compact_bounds(jax, jnp, K, CAP, tok_pack, keep_lo, keep_hi):
    """Compact tape rows [keep_lo, keep_hi) per cursor -> (M, comp,
    kcnt); shared by the splice fast path and the repair path.

    A stable 2-operand sort on the drop flag keeps kept tokens in
    original order at the front (instead of a K*CAP-element
    scatter-max)."""
    col = jnp.arange(CAP, dtype=jnp.int32)[None, :]
    mask = (col >= keep_lo[:, None]) & (col < keep_hi[:, None])
    flat_mask = mask.reshape(K * CAP)
    M = jnp.sum(flat_mask.astype(jnp.int32))
    key = (~flat_mask).astype(jnp.int32)
    _, comp = jax.lax.sort(
        (key, jnp.where(flat_mask, tok_pack, jnp.uint32(0))),
        num_keys=1, is_stable=True,
    )
    kcnt = jnp.clip(keep_hi - keep_lo, 0, CAP)
    return M, comp, kcnt


@functools.lru_cache()
def make_compact_bounds(K: int, CAP: int):
    """Jitted compaction with HOST-supplied keep bounds (repair path)."""
    jax, jnp = _jnp()

    @jax.jit
    def compact(tok_pack, keep_lo, keep_hi):
        return _compact_bounds(jax, jnp, K, CAP, tok_pack, keep_lo, keep_hi)

    return compact


@functools.lru_cache()
def make_row_gather(K: int, CAP: int, R: int):
    """Jitted tape-row gather: pull R cursors' bit-position rows without
    pulling the whole (K, CAP) tape to the host."""
    jax, jnp = _jnp()

    @jax.jit
    def gather(tok_bp, idx):
        return tok_bp.reshape(K, CAP)[jnp.clip(idx, 0, K - 1)]

    return gather


@functools.lru_cache()
def make_expand_v2(T: int, out_cap: int):
    """Jitted masked-tape expansion with early-exit pointer doubling.

    expand(comp u32[T], M, window u8[32768], wlen) ->
      (out u8[out_cap], total i32)
    total > out_cap signals capacity overflow (caller retries bigger)."""
    jax, jnp = _jnp()
    W = 1 << 15

    @jax.jit
    def expand(comp, M, window):
        tid_dom = jnp.arange(T, dtype=jnp.int32)
        valid = tid_dom < M
        is_m = valid & (((comp >> jnp.uint32(25)) & 1) == 1)
        ll = (comp & jnp.uint32(0x1FF)).astype(jnp.int32)
        dd = ((comp >> jnp.uint32(9)) & jnp.uint32(0xFFFF)).astype(jnp.int32)
        out_len = jnp.where(valid, jnp.where(is_m, ll, 1), 0)
        starts = jnp.cumsum(out_len) - out_len
        total = jnp.sum(out_len)

        tid_seed = jnp.full(out_cap, -1, jnp.int32)
        scatter_idx = jnp.where(valid, jnp.minimum(starts, out_cap - 1), out_cap - 1)
        tid_seed = tid_seed.at[scatter_idx].max(jnp.where(valid, tid_dom, -1))
        tid = jax.lax.cummax(tid_seed)
        tid = jnp.clip(tid, 0, T - 1)

        i = jnp.arange(out_cap, dtype=jnp.int32)
        start_b = starts[tid]
        d = jnp.where(is_m[tid], dd[tid], 0)
        jcol = i - start_b
        is_copy_b = (d > 0) & (i < total)
        src = start_b - d + jnp.where(d > 0, jcol % jnp.maximum(d, 1), 0)

        ptr = jnp.arange(W + out_cap, dtype=jnp.int32)
        ptr = ptr.at[W:].set(jnp.where(is_copy_b, src + W, ptr[W:]))
        vals = jnp.concatenate(
            [window, jnp.where(is_copy_b, 0, ll[tid]).astype(jnp.uint8)]
        )

        def cond(state):
            ptr, changed = state
            return changed

        def body(state):
            ptr, _ = state
            ptr2 = ptr[ptr]
            return ptr2, jnp.any(ptr2 != ptr)

        ptr, _ = jax.lax.while_loop(cond, body, (ptr, jnp.bool_(True)))
        out = vals[ptr[W:]]
        return out, total

    return expand


class _Plan:
    __slots__ = ("starts", "stops", "block_of", "K", "Kpad", "stride_bits",
                 "luts_lit", "luts_dist", "meta")


def _cursor_plan(buf: np.ndarray, stride_bits: int, max_cursors: int):
    plan = _plan_blocks(buf)
    if plan is None:
        return None
    spans = [max(1, p[2] - p[1]) for p in plan]
    if len(plan) >= max_cursors:
        return None
    # the stream's cursors fit the budget: each block rounds its cursor
    # count up by at most one, so sum(ceil(span / stride)) <= max_cursors
    stride_bits = -(
        -max(stride_bits, -(-sum(spans) // (max_cursors - len(plan)))) // 4096
    ) * 4096
    starts, stops, block_of = [], [], []
    first, last, bstart, stored_f = [], [], [], []
    for b, p in enumerate(plan):
        _, ds, stop, _, _, _, is_stored = p[:7]
        span = max(1, stop - ds)
        nseg = max(1, min(-(-span // stride_bits), max_cursors))
        bounds = [ds + (span * i) // nseg for i in range(nseg)]
        if is_stored:
            # stored data is byte-aligned: cursor starts must be too
            bounds = sorted({ds + (((bb - ds) >> 3) << 3) for bb in bounds})
            nseg = len(bounds)
        for i, s in enumerate(bounds):
            starts.append(s)
            stops.append(bounds[i + 1] if i + 1 < nseg else stop)
            block_of.append(b)
            first.append(i == 0)
            last.append(i == nseg - 1)
            bstart.append(ds)
            stored_f.append(is_stored)
    K = len(starts)
    if K > max_cursors:
        return None
    out = _Plan()
    out.K = K
    out.Kpad = 1 << max(5, (K - 1).bit_length())
    out.stride_bits = stride_bits
    out.starts = starts
    out.stops = stops
    out.block_of = block_of
    out.luts_lit = np.concatenate([p[3][0] for p in plan])
    out.luts_dist = np.concatenate([p[3][1] for p in plan])
    out.meta = (first, last, bstart, plan, stored_f)
    return out


@functools.lru_cache()
def make_inflate_fused(K: int, CAP: int, out_cap: int):
    """ONE-dispatch tokenize + splice + expand.

    Where the staged pipeline makes three dispatches and syncs on
    int(ok) mid-flight, this single jit program returns a small meta
    vector
    [ok, M, total, end_pos(K), status(K), kcnt(K)] plus the expanded
    output and the compact tape (pulled lazily only on the host-expand
    paths)."""
    jax, jnp = _jnp()
    splice = make_splice_compact(K, CAP)
    expand = make_expand_v2(K * CAP, out_cap)

    @jax.jit
    def run(w32, starts, stops_dec, block_of, luts_lit, luts_dist,
            avail_bits, stops, block_starts, first, last, expect_eob,
            active, win):
        tok_pack, tok_bp, cnt, end_pos, status, eob_idx = (
            cursor_tokenize_body(
                jax, jnp, CAP, w32, starts, stops_dec, block_of,
                luts_lit, luts_dist, avail_bits, expect_eob,
            )
        )
        smeta, comp, kcnt = splice(
            tok_pack, tok_bp, cnt, end_pos, status, stops, block_starts,
            first, last, expect_eob, active, eob_idx,
        )
        out, total = expand(comp, smeta[1], win)
        meta = jnp.concatenate(
            [smeta[:2], total[None], end_pos, status, kcnt]
        )
        return meta, out, comp

    return run


def _native_midblock(p):
    """Native bridge decoder for a plan entry, or None (no native lib /
    stored block).  Returns fn(buf, bit, cap) -> (litlen, dist, hit_eob,
    end_bit) or None on decode error."""
    lens_info = p[7]
    if lens_info[0] not in ("dyn", "fixed"):
        return None
    try:
        from ..native.bindings import get_lib, native_available

        if not native_available():
            return None
        lib = get_lib()
    except Exception:  # pragma: no cover
        return None
    import ctypes

    from ..codec.tables import FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS
    from ..native.api import _p32, _p8

    if lens_info[0] == "fixed":
        ll_arr = np.ascontiguousarray(FIXED_LITLEN_LENGTHS, dtype=np.int32)
        dd_arr = np.ascontiguousarray(FIXED_DIST_LENGTHS, dtype=np.int32)
    else:
        ll_arr = np.ascontiguousarray(lens_info[1], dtype=np.int32)
        dd_arr = np.ascontiguousarray(lens_info[2], dtype=np.int32)

    def run(buf, bit, cap):
        lit_buf = np.empty(cap, np.int32)
        dist_buf = np.empty(cap, np.int32)
        eb = ctypes.c_int64(0)
        he = ctypes.c_int32(0)
        st = ctypes.c_int32(0)
        ntok = lib.tz_tokenize_midblock(
            _p8(buf), np.int64(len(buf)), np.int64(bit),
            _p32(ll_arr), np.int32(len(ll_arr)),
            _p32(dd_arr), np.int32(len(dd_arr)),
            _p32(lit_buf), _p32(dist_buf), np.int64(cap),
            ctypes.byref(eb), ctypes.byref(he), ctypes.byref(st),
        )
        if st.value != 0:
            return None
        return (
            lit_buf[:ntok].copy(), dist_buf[:ntok].copy(),
            he.value != 0, int(eb.value),
        )

    return run


def _repair_splice(buf, avail_bits, Kpad, CAP, K, plan, block_a, stops_a,
                   first_a, last_a, bstart_a, active_a, stored_a,
                   expect_eob_a, cnt_np, st_np, end_np, diag_np, tok_bp,
                   eob_np=None):
    """Host repair when speculative splicing fails (ok == 0).

    Speculation breaks in two data-dependent ways: a cursor's garbage
    prefix decodes a spurious EOB (p ~ 2^-13 per garbage symbol — near
    -certain somewhere in a stream with thousands of cursors), or a
    cursor fails to self-sync inside the overlap window.  Both leave
    every OTHER cursor's work intact, so instead of abandoning the
    stream this walks cursors left-to-right per block, trusts exactly
    the validated chain (the same induction the device splice uses), and
    HOST-decodes only the broken spans with the vectorized segment
    decoder, re-entering the next cursor whose tape contains a decoded
    chain position.  Reference semantics are unchanged — this is pure
    scheduling recovery (the reference's serial decode has no analog).

    Returns (keep_lo, keep_hi, bridge_ins, block_end_bits) or None when
    the stream needs the full host engine (real data errors, truncation,
    unparseable structure).

    WORST-CASE BOUND: a pathological stream could
    break thousands of boundaries, degenerating this walk into host-
    decode-everything plus a device row-pull per bridge.  Bridges and
    lazy row batches are therefore CAPPED (TPUZLIB_REPAIR_MAX_BRIDGES /
    TPUZLIB_REPAIR_MAX_ROW_BATCHES, default 64 each — a healthy 8 MB
    stream repairs with ~1-3 bridges); past the cap the repair declines
    ONCE (trace counter inflate.repair_cap_exceeded) and the caller
    takes the single full host fallback instead of a transfer storm."""
    import os as _os
    import time as _time

    import jax.numpy as jnp

    from ..utils import trace as _trace

    max_bridges = int(_os.environ.get("TPUZLIB_REPAIR_MAX_BRIDGES", "64"))
    max_row_batches = int(
        _os.environ.get("TPUZLIB_REPAIR_MAX_ROW_BATCHES", "64")
    )

    _CapExceeded = RepairCapExceeded

    _rt = {"rows": 0.0, "decode": 0.0, "nbridge": 0, "nrows": 0}
    _t00 = _time.time()
    jstop, anyc, firstc, jentry, bp0, bp_cut = diag_np
    keep_lo = np.full(Kpad, CAP, np.int32)
    keep_hi = np.zeros(Kpad, np.int32)
    bridge_ins: dict[int, tuple] = {}
    block_end_bits: list[int] = []
    row_cache: dict[int, np.ndarray] = {}
    RG = 16
    gather = make_row_gather(Kpad, CAP, RG)

    # prefetch the tape rows the bridges will plausibly probe
    # (successors of failed boundaries and of mid-block EOB cursors) in
    # ONE batched gather instead of a device round-trip per row.
    # Block-LAST cursors are excluded: their anyc is legitimately false
    # (no boundary) and including them would pull ~12 needless rows per
    # block.
    eobk = (
        eob_np[:K] >= 0 if eob_np is not None else np.zeros(K, bool)
    )
    suspects = np.flatnonzero(
        active_a[:K]
        & ~last_a[:K]
        & (~anyc[:K].astype(bool) | (st_np[:K] == ST_EOB) | eobk)
    )
    want: list[int] = []
    for s in suspects:
        want.append(int(s))  # early-EOB cuts read the cursor's OWN row
        # 32 successors: the same one-bucket gather as 12 (32-row
        # buckets), and wide enough that bridge syncs landing past s+12
        # do not trigger lazy get_row round-trips
        want.extend(range(int(s) + 1, min(int(s) + 33, K)))
    want = sorted(set(want))
    if want:
        # 32-row buckets: one compiled gather shape, small pulls
        for base in range(0, len(want), 32):
            chunk = want[base : base + 32]
            idxs = np.full(32, chunk[-1], np.int32)
            idxs[: len(chunk)] = chunk
            g32 = make_row_gather(Kpad, CAP, 32)
            rows = np.asarray(g32(tok_bp, jnp.asarray(idxs)))
            for i, kk in enumerate(chunk):
                row_cache[int(kk)] = rows[i]

    def get_row(k):
        if k not in row_cache:
            if _rt["nrows"] >= max_row_batches:
                raise _CapExceeded("row batches")
            t0 = _time.time()
            base = min(k, Kpad - RG)
            idxs = np.arange(base, base + RG, dtype=np.int32)
            rows = np.asarray(gather(tok_bp, jnp.asarray(idxs)))
            for i, kk in enumerate(idxs):
                row_cache[int(kk)] = rows[i]
            _rt["rows"] += _time.time() - t0
            _rt["nrows"] += 1
        return row_cache[k]

    blk_np = block_a[:K]
    for b, p in enumerate(plan):
        idxs = np.flatnonzero((blk_np == b) & active_a[:K])
        if len(idxs) == 0:
            return None
        luts = p[3]
        current = int(idxs[0])
        if not (cnt_np[current] == 0 or bp0[current] == bstart_a[current]):
            return None  # unanchored block start: real decode problem
        keep_lo[current] = 0
        b_end = None
        while True:
            st = st_np[current]
            e_i = int(eob_np[current]) if eob_np is not None else -1
            early = (
                e_i >= 0
                and e_i >= int(keep_lo[current])
                and e_i < int(cnt_np[current])
            )
            if early:
                # a KEPT flagged EOB (round-5 EOB-continuation kernels):
                # the block really ended inside this trusted cursor's
                # span — cut BEFORE the flag and bridge from its bit
                # position; the bridge decodes the EOB immediately and
                # closes the block (hidden stored runs follow via the
                # host gap walk, infblocks.ts:243-333 semantics)
                cut_idx = e_i
                bridge_pos = int(get_row(current)[e_i])
            elif st == ST_EOB:
                # trusted EOB (current is entry-validated): real block end
                keep_hi[current] = cnt_np[current]
                b_end = int(end_np[current])
                break
            elif st in (ST_ERR, ST_OOB):
                return None  # trusted error/truncation: full fallback
            elif current == idxs[-1] and not expect_eob_a[current]:
                keep_hi[current] = cnt_np[current]
                b_end = int(end_np[current])
                break
            else:
                nxt = current + 1
                if (
                    current != idxs[-1]
                    and anyc[current]
                    and cnt_np[nxt] > 0
                ):
                    keep_hi[current] = min(
                        int(jstop[current] + firstc[current]),
                        int(cnt_np[current]),
                    )
                    keep_lo[nxt] = jentry[current]
                    current = nxt
                    continue
                if jstop[current] >= cnt_np[current]:
                    return None
                cut_idx = int(jstop[current])
                bridge_pos = int(bp_cut[current])

            # ---- bridge: host-decode from current's cut ---------------
            keep_hi[current] = cut_idx
            pos = bridge_pos
            if _rt["nbridge"] >= max_bridges:
                raise _CapExceeded("bridges")
            _rt["nbridge"] += 1
            _t0b = _time.time()
            targets = [int(k2) for k2 in idxs if k2 > current]
            guard_end = int(stops_a[int(idxs[-1])]) + 4096
            # bridge decode: the native serial mid-block tokenizer
            # (O(symbols) from a known chain position with the block's
            # parsed lengths); the vectorized numpy decoder
            # (O(segment_bits): a candidate at EVERY bit position) only
            # remains as the no-native / stored-block fallback
            nat = _native_midblock(p)
            if nat is None:
                # bridge-local bit windows for the numpy fallback
                wbyte0 = pos >> 3
                wspan = min(len(buf) - wbyte0, (guard_end - pos) // 8 + 64)
                w64loc = tk.byte_windows64(buf[wbyte0 : wbyte0 + wspan])
                wbase = wbyte0 * 8
                avail_loc = min(avail_bits - wbase, wspan * 8)
            lit_parts, dist_parts = [], []
            sync = None
            while True:
                if nat is not None:
                    # ~one cursor stride of tokens per chunk: sync is
                    # checked at chunk ends, so smaller chunks sync at
                    # the first eligible cursor instead of overshooting
                    # (env knob: regression tests force big chunks)
                    res = nat(
                        buf, pos,
                        int(_os.environ.get("TPUZLIB_BRIDGE_CHUNK", "1024")),
                    )
                    if res is None:
                        return None
                    litl, dst, hit_eob, newpos = res
                    kind = tk.EXIT_EOB if hit_eob else -1
                else:
                    try:
                        litl, dst, kind, npos_rel = tk.decode_segment(
                            w64loc, pos - wbase, avail_loc, luts[0],
                            luts[1], 4096,
                        )
                        newpos = npos_rel + wbase
                    except tk.DataError:
                        return None
                lit_parts.append(litl)
                dist_parts.append(dst)
                if kind == tk.EXIT_EOB:
                    b_end = newpos
                    break
                if kind == tk.EXIT_MORE:
                    return None  # truncated input
                pos = newpos
                hit = None
                for k2 in targets:
                    if cnt_np[k2] == 0 or pos > int(stops_a[k2]) + 2048:
                        continue
                    row = get_row(k2)[: cnt_np[k2]]
                    ii = int(np.searchsorted(row, pos))
                    # the sync index must land BEFORE k2's own boundary
                    # cut (jstop): a long bridge chunk can overshoot
                    # into k2's overlap tail, where accepting the sync
                    # would make the NEXT cursor's entry point sit
                    # before the bridge end — duplicated tokens (round
                    # -5 regression caught by the api integrity check:
                    # 15 doubled tokens at a 4096-token bridge seam)
                    if (
                        ii < cnt_np[k2]
                        and row[ii] == pos
                        and ii < int(jstop[k2])
                    ):
                        hit = (k2, ii)
                        break
                if hit is not None:
                    sync = hit
                    break
                if pos > guard_end:
                    return None
            _rt["decode"] += _time.time() - _t0b
            if lit_parts:
                bridge_ins[current] = (
                    np.concatenate(lit_parts),
                    np.concatenate(dist_parts),
                )
            if b_end is not None:
                break  # bridge hit the real EOB: block done
            k2, ii = sync
            keep_lo[k2] = ii  # cursors (current, k2) stay dead
            current = k2
        block_end_bits.append(b_end)
    _trace.count("inflate.repair_bridge", _rt["nbridge"])
    if _os.environ.get("TPUZLIB_TIME_INFLATE"):
        print(
            f"[repair] total {(_time.time()-_t00)*1000:.0f} ms; "
            f"bridges {_rt['nbridge']}, decode {_rt['decode']*1000:.0f} ms, "
            f"lazy row batches {_rt['nrows']} ({_rt['rows']*1000:.0f} ms)",
            flush=True,
        )
    return keep_lo, keep_hi, bridge_ins, block_end_bits


def _debug_splice_fail(bp2, cnt, status, stops, first_a, last_a, bstart_a,
                       expect_eob_a, active_a, K):
    """Numpy replica of the splice's per-cursor checks; prints the first
    failing cursors (TPUZLIB_DEBUG_INFLATE only)."""
    import collections

    Kpad, CAP = bp2.shape
    print("[debug] splice ok=0; statuses:",
          dict(collections.Counter(status[:K].tolist())))
    eobf = active_a & (status == ST_EOB)
    c = np.cumsum(eobf.astype(np.int64))
    base = np.maximum.accumulate(
        np.where(first_a, c - eobf.astype(np.int64), 0)
    )
    garbage = active_a & ((c - eobf.astype(np.int64) - base) > 0)
    efflast = ~garbage & (eobf | last_a)
    next_first = np.concatenate([first_a[1:], np.ones(1, bool)])
    boundary = active_a & ~garbage & ~efflast & ~next_first
    nfail = 0
    for k in range(K):
        if not active_a[k]:
            continue
        good = garbage[k] or eobf[k] or (
            (status[k] == ST_STRIDE_END)
            and not (last_a[k] and expect_eob_a[k])
        )
        anch = first_a[k] and (cnt[k] == 0 or bp2[k, 0] == bstart_a[k])
        bfail = False
        if boundary[k]:
            row = bp2[k][: cnt[k]]
            jstop = np.searchsorted(row, stops[k])
            cand = bp2[k][jstop : jstop + 192]
            cand = cand[cand < (1 << 29)]
            nxt = bp2[k + 1][: cnt[k + 1]]
            bfail = not np.isin(cand, nxt).any()
        if (not good) or bfail or (first_a[k] and not anch):
            print(f"[debug] cursor {k}: status={status[k]} cnt={cnt[k]} "
                  f"first={bool(first_a[k])} last={bool(last_a[k])} "
                  f"boundary={bool(boundary[k])} good={good} "
                  f"anchored={anch} bfail={bfail} stop={stops[k]} "
                  f"bp0={bp2[k,0]} bstart={bstart_a[k]} "
                  f"bp_tail={bp2[k, max(0,cnt[k]-3):cnt[k]].tolist()}")
            if boundary[k] and bfail:
                row = bp2[k][: cnt[k]]
                jstop = np.searchsorted(row, stops[k])
                print(f"        cand[:6]={bp2[k][jstop:jstop+6].tolist()} "
                      f"next_row[:6]={bp2[k+1][:6].tolist()} "
                      f"next_cnt={cnt[k+1]}")
            nfail += 1
            if nfail >= 5:
                break


def inflate_device_v2(
    data: np.ndarray,
    dictionary: np.ndarray | None = None,
    stride_bits: int | None = None,
    max_cursors: int | None = None,
    size_hint: int | None = None,
    device_expand: bool = False,
    mesh=None,
):
    """One-shot raw-DEFLATE decode, all heavy work on device.

    Pass 1 (host): speculative block-header discovery + LUT build.
    Pass 2 (device): K-cursor tokenize (the XLA while_loop in
    cursor_tokenize_body), then splice validation and compaction.
    Pass 3: native host expansion (default) or device LZ expansion via
    early-exit pointer doubling (device_expand=True).

    With `mesh`, pass 2's tokenize runs as a shard_map over the mesh's
    "shards" axis (cursors are embarrassingly parallel; the compressed
    stream and LUTs are replicated) — the multi-device inflate path.

    Returns decompressed bytes, or None when the stream needs the host
    engine (stored blocks, failed discovery/speculation, token-cap
    overflow)."""
    import os as _os

    jax, jnp = _jnp()
    if stride_bits is None:
        stride_bits = 1 << 15
    if max_cursors is None:
        max_cursors = 2048
    buf = np.ascontiguousarray(np.asarray(data))
    avail_bits = len(buf) * 8
    cp = _cursor_plan(buf, stride_bits, max_cursors)
    if cp is None:
        return None
    K, Kpad, stride_bits = cp.K, cp.Kpad, cp.stride_bits
    if mesh is not None:
        ndev = int(mesh.devices.size)
        Kpad = ndev * (-(-Kpad // ndev))
    OVERLAP = 1024  # bits decoded past each stop for chain intersection
    # non-first cursors ALSO start one overlap early (inside the previous
    # cursor's solid region): self-sync then has 2*OVERLAP bits to land
    # inside the candidate window instead of 1 (with a single overlap
    # about one boundary in 3000 missed sync on an 8 MB stream)
    CAP = max(64, (stride_bits + 3 * OVERLAP) // 6)

    starts_a = np.full(Kpad, -1, np.int32)
    stops_a = np.zeros(Kpad, np.int32)
    block_a = np.zeros(Kpad, np.int32)
    starts_a[:K] = cp.starts
    stops_a[:K] = cp.stops
    block_a[:K] = cp.block_of
    first, last, bstart, plan, stored_f = cp.meta
    # padding rows count as block-firsts so a real block-last cursor
    # followed by padding is not mistaken for an intra-block boundary
    first_a = np.ones(Kpad, bool); first_a[:K] = first
    last_a = np.ones(Kpad, bool); last_a[:K] = last
    bstart_a = np.zeros(Kpad, np.int32); bstart_a[:K] = bstart
    active_a = np.zeros(Kpad, bool); active_a[:K] = True
    stored_a = np.zeros(Kpad, bool); stored_a[:K] = stored_f
    # stored-block last cursors must stop exactly at the block end (their
    # decode is deterministic; overlap would swallow the next header as
    # fake literals); everyone else decodes OVERLAP bits past the stop
    stops_dec = np.where(last_a & stored_a, stops_a, stops_a + OVERLAP)
    expect_eob_a = last_a & ~stored_a
    # early speculative starts (see OVERLAP comment above): never before
    # the block's data start, and never for anchored block-first or
    # deterministic stored cursors
    early = active_a & ~first_a & ~stored_a
    starts_a = np.where(
        early, np.maximum(bstart_a, starts_a - OVERLAP), starts_a
    ).astype(np.int32)

    w32 = _build_w32(jnp, jnp.asarray(buf))
    window = (
        dictionary[-((1 << 15) - 1):].astype(np.uint8)
        if dictionary is not None and len(dictionary)
        else np.empty(0, np.uint8)
    )
    win = np.zeros(1 << 15, np.uint8)
    if len(window):
        win[-len(window):] = window

    any_open = any(p[5] for p in plan)
    # TPUZLIB_FUSED=1 opts INTO the single fused tokenize+splice+expand
    # program; the default is the staged dispatches, the measured path.
    use_fused = (
        mesh is None and device_expand and not any_open
        and _os.environ.get("TPUZLIB_FUSED", "0") == "1"
    )
    out = None
    total = 0
    repair = None
    import time as _time

    _tt = [_time.time()]
    _tlog = []

    def _tick(name):
        if _os.environ.get("TPUZLIB_TIME_INFLATE"):
            now = _time.time()
            _tlog.append((name, round((now - _tt[0]) * 1000, 1)))
            _tt[0] = now

    if use_fused:
        out_cap = size_hint or (8 * len(buf) + (1 << 16))
        out_cap = 1 << max(16, int(out_cap - 1).bit_length())
        while True:
            runf = make_inflate_fused(Kpad, CAP, out_cap)
            meta, out, comp = runf(
                w32, jnp.asarray(starts_a), jnp.asarray(stops_dec),
                jnp.asarray(block_a), jnp.asarray(cp.luts_lit),
                jnp.asarray(cp.luts_dist), np.int32(avail_bits),
                jnp.asarray(stops_a), jnp.asarray(bstart_a),
                jnp.asarray(first_a), jnp.asarray(last_a),
                jnp.asarray(expect_eob_a), jnp.asarray(active_a),
                jnp.asarray(win),
            )
            meta_np = np.asarray(meta)  # the ONE synchronizing pull
            if int(meta_np[0]) != 1:
                return None
            M = int(meta_np[1])
            total = int(meta_np[2])
            if total <= out_cap:
                break
            out_cap = 1 << int(total - 1).bit_length()
        end_np = meta_np[3 : 3 + Kpad][:K]
        st_np = meta_np[3 + Kpad : 3 + 2 * Kpad][:K]
        kcnt_np = meta_np[3 + 2 * Kpad : 3 + 3 * Kpad][:K]
    else:
        if mesh is None:
            tokf = make_cursor_tokenize(Kpad, CAP)
            tok_pack, tok_bp, cnt, end_pos, status, eob_idx = tokf(
                w32,
                jnp.asarray(starts_a),
                jnp.asarray(stops_dec),
                jnp.asarray(block_a),
                jnp.asarray(cp.luts_lit),
                jnp.asarray(cp.luts_dist),
                np.int32(avail_bits),
                jnp.asarray(expect_eob_a),
            )
        else:
            sharded_tok = _make_sharded_tokenize(mesh, CAP)
            tok_pack, tok_bp, cnt, end_pos, status, eob_idx = sharded_tok(
                w32,
                jnp.asarray(starts_a),
                jnp.asarray(stops_dec),
                jnp.asarray(block_a),
                jnp.asarray(cp.luts_lit),
                jnp.asarray(cp.luts_dist),
                np.int32(avail_bits),
                jnp.asarray(expect_eob_a),
            )
            # gather shards before the splice: auto-partitioning the
            # splice's gathers over the mesh emits per-iteration
            # collectives that crawl (and rendezvous-stall) on hosts
            # with fewer cores than devices
            tok_pack, tok_bp, cnt, end_pos, status, eob_idx = (
                jnp.asarray(np.asarray(x))
                for x in (tok_pack, tok_bp, cnt, end_pos, status, eob_idx)
            )
        splice = make_splice_compact(Kpad, CAP)
        _tick("pre_splice")
        smeta, comp, _kcnt_dev = splice(
            tok_pack, tok_bp, cnt, end_pos, status,
            jnp.asarray(stops_a), jnp.asarray(bstart_a),
            jnp.asarray(first_a), jnp.asarray(last_a),
            jnp.asarray(expect_eob_a), jnp.asarray(active_a),
            eob_idx,
        )
        # ONE device-to-host pull for every host-consumed splice vector
        meta_np = np.asarray(smeta)
        ok = int(meta_np[0])
        M = int(meta_np[1])
        _tick("splice_pull")
        end_np = _meta_vec(meta_np, Kpad, META_END)[:K]
        st_np = _meta_vec(meta_np, Kpad, META_ST)[:K]
        kcnt_np = _meta_vec(meta_np, Kpad, META_KCNT)[:K]
        # TPUZLIB_FORCE_REPAIR=1 exercises the repair path on healthy
        # streams (tests): it must reproduce the fast path's output
        if ok != 1 or _os.environ.get("TPUZLIB_FORCE_REPAIR") == "1":
            diag_np = tuple(
                _meta_vec(meta_np, Kpad, i)
                for i in (META_JSTOP, META_ANYC, META_FIRSTC, META_JENTRY,
                          META_BP0, META_BPCUT)
            )
            try:
                repair = _repair_splice(
                    buf, avail_bits, Kpad, CAP, K, plan,
                    np.asarray(block_a), stops_a, first_a, last_a, bstart_a,
                    active_a, stored_a, expect_eob_a,
                    _meta_vec(meta_np, Kpad, META_CNT),
                    _meta_vec(meta_np, Kpad, META_ST),
                    _meta_vec(meta_np, Kpad, META_END),
                    diag_np,
                    tok_bp,
                    eob_np=_meta_vec(meta_np, Kpad, META_EOB),
                )
            except RepairCapExceeded as cap:
                from ..utils import trace as _trace

                _trace.count("inflate.repair_cap_exceeded", 1)
                import logging

                logging.getLogger("tpuzlib").warning(
                    "splice repair exceeded its %s cap; taking the single "
                    "full host fallback", cap,
                )
                repair = None
            if repair is None:
                if _os.environ.get("TPUZLIB_DEBUG_INFLATE"):
                    _debug_splice_fail(
                        np.asarray(tok_bp).reshape(Kpad, CAP),
                        np.asarray(cnt), np.asarray(status), stops_a,
                        first_a, last_a, bstart_a, expect_eob_a,
                        active_a, K,
                    )
                return None
            keep_lo_r, keep_hi_r, bridge_ins, rep_block_ends = repair
            from ..utils import trace as _trace

            _trace.count("inflate.splice_repair", 1)
            _tick("repair_walk")
            compact = make_compact_bounds(Kpad, CAP)
            M_r, comp, kcnt_r = compact(
                tok_pack, jnp.asarray(keep_lo_r), jnp.asarray(keep_hi_r)
            )
            M = int(M_r)
            kcnt_np = np.asarray(kcnt_r)[:K]
        _tick("compact")

    # host validation of block chaining: between block b's EOB and block
    # b+1's header there may be sync markers AND non-empty stored runs
    # (the latter invisible to discovery — their bytes splice in below)
    blk_np = np.asarray(cp.block_of[:K])
    if use_fused or repair is None:
        # effective block end: the FIRST cursor that hit EOB (early in
        # -block EOB means a stored run follows), else the planned last
        block_last_idx = []
        for b in range(len(plan)):
            idxs = np.flatnonzero(blk_np == b)
            hits = idxs[st_np[idxs] == ST_EOB]
            block_last_idx.append(
                int(hits[0]) if len(hits) else int(idxs[-1])
            )
        block_end_bits = [int(end_np[k]) for k in block_last_idx]
        bridge_ins = {}
    else:
        block_end_bits = rep_block_ends
    tail_tokens = None
    insertions: dict[int, list] = {}
    _dbg = _os.environ.get("TPUZLIB_DEBUG_INFLATE")
    for bi in range(len(plan)):
        block_end = block_end_bits[bi]
        is_final_planned = bi == len(plan) - 1
        _, _, _, _, bfinal, open_end, _ = plan[bi][:7]
        if not is_final_planned:
            walk = _walk_gap(
                buf, block_end, avail_bits, stop_at=plan[bi + 1][0]
            )
            if walk is None:
                if _dbg:
                    print(f"[debug] walk-gap None: block {bi} end_bit "
                          f"{block_end} next_hdr {plan[bi + 1][0]}")
                return None
            nxt_bit, final, ranges = walk
            if final or nxt_bit != plan[bi + 1][0]:
                if _dbg:
                    print(f"[debug] walk-gap mismatch: block {bi} end "
                          f"{block_end} -> {nxt_bit} final={final} expect "
                          f"{plan[bi + 1][0]}")
                return None
            if ranges:
                insertions[bi] = ranges
        else:
            if bfinal:
                pass  # stream ends with this block
            elif open_end:
                # discovery stopped here: decode the remainder on host
                from ..parallel.speculative import _tokenize_range

                litlen_t, dist_t, _, fin = _tokenize_range(
                    buf, None, block_end, avail_bits, avail_bits
                )
                if not fin:
                    return None
                tail_tokens = (litlen_t, dist_t)
            else:
                walk = _walk_gap(buf, block_end, avail_bits)
                if walk is None or not walk[1]:
                    return None
                if walk[2]:
                    insertions[bi] = walk[2]

    if (
        not device_expand
        or tail_tokens is not None
        or insertions
        or repair is not None
    ):
        comph = np.asarray(comp[:M])
        _tick("comp_pull")
        is_m = (comph >> 25) & 1
        litlen = (comph & 0x1FF).astype(np.int32)
        dist = np.where(is_m == 1, (comph >> 9) & 0xFFFF, 0).astype(np.int32)
        if repair is not None:
            # sequential per-cursor assembly: kept slices + host-decoded
            # bridge tokens at cursor boundaries + stored literal runs at
            # block boundaries
            cum = np.concatenate(
                [[0], np.cumsum(kcnt_np.astype(np.int64))]
            )
            lparts, dparts = [], []
            for b in range(len(plan)):
                idxs = np.flatnonzero((blk_np == b) & active_a[:K])
                for k in idxs:
                    lparts.append(litlen[cum[k] : cum[k + 1]])
                    dparts.append(dist[cum[k] : cum[k + 1]])
                    if int(k) in bridge_ins:
                        bl, bd = bridge_ins[int(k)]
                        lparts.append(bl)
                        dparts.append(bd)
                for (bs, ln) in insertions.get(b, ()):
                    lparts.append(buf[bs : bs + ln].astype(np.int32))
                    dparts.append(np.zeros(ln, np.int32))
            litlen = np.concatenate(lparts) if lparts else litlen[:0]
            dist = np.concatenate(dparts) if dparts else dist[:0]
        elif insertions:
            # token count per planned block -> insertion offsets
            kc = np.asarray(kcnt_np).astype(np.int64)
            blk = np.asarray(cp.block_of, np.int64)
            per_block = np.bincount(blk, weights=kc, minlength=len(plan))
            block_end_tok = np.cumsum(per_block).astype(np.int64)
            lparts, dparts, prev = [], [], 0
            for bi in sorted(insertions):
                cut = int(block_end_tok[bi])
                lparts.append(litlen[prev:cut])
                dparts.append(dist[prev:cut])
                for (bs, ln) in insertions[bi]:
                    lparts.append(buf[bs : bs + ln].astype(np.int32))
                    dparts.append(np.zeros(ln, np.int32))
                prev = cut
            lparts.append(litlen[prev:])
            dparts.append(dist[prev:])
            litlen = np.concatenate(lparts)
            dist = np.concatenate(dparts)
        if tail_tokens is not None:
            litlen = np.concatenate([litlen, tail_tokens[0]])
            dist = np.concatenate([dist, tail_tokens[1]])
        from ..codec.expand import expand_host

        _tick("token_splice")
        r = expand_host(litlen, dist, window)
        _tick("host_expand")
        if _tlog:
            print("[time]", _tlog, flush=True)
        return r

    if use_fused:
        return np.asarray(out)[:total]

    out_cap = size_hint or (8 * len(buf) + (1 << 16))
    out_cap = -(-out_cap // 1024) * 1024
    while True:
        expand = make_expand_v2(Kpad * CAP, out_cap)
        out, total_d = expand(comp, M, jnp.asarray(win))
        t = int(total_d)
        if t <= out_cap:
            return np.asarray(out)[:t]
        out_cap = -(-t // 1024) * 1024
