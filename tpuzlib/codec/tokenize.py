"""Pass 1 of the two-pass inflate: DEFLATE bitstream -> token tape.

Redesign of the reference's serial symbol loop (src/infcodes.ts:62-301
inflate_fast + :314-676 slow path; src/infblocks.ts:123-628 block FSM).
Instead of walking the bit cursor one symbol at a time, we decode a
*candidate token at every bit position* of a segment with vectorized
gathers (flat 15-bit LUTs), then extract the true symbol sequence by
pointer-doubling over the per-position jump graph.  The same algorithm
serves numpy on host and (in kernels/) jax on device — redundant work per
position, but embarrassingly parallel.

Token tape representation: two int32 arrays
    litlen: literal byte value (dist == 0) or match length 3..258
    dist:   0 for literals, else match distance 1..32768
"""

from __future__ import annotations

import numpy as np

from . import huffman
from .tables import CLC_ORDER


class NeedMoreInput(Exception):
    """Raised when the buffered input ends mid-structure; resume later."""


class DataError(ValueError):
    """Malformed DEFLATE data (parity with reference z.msg DATA_ERROR)."""


# --- bit access helpers -----------------------------------------------------


def byte_windows64(buf: np.ndarray) -> np.ndarray:
    """Per-byte 64-bit little-endian windows: w64[k] = bits 8k..8k+63.

    With an in-byte shift of at most 7, every bit position can read 57
    contiguous stream bits — enough for the worst-case composite token
    (15 len + 5 extra + 15 dist + 13 extra = 48 bits)."""
    n = len(buf)
    padded = np.concatenate([buf, np.zeros(8, dtype=np.uint8)]).astype(np.uint64)
    w = np.zeros(n, dtype=np.uint64)
    for j in range(8):
        w |= padded[j : j + n] << np.uint64(8 * j)
    return w


class BitReader:
    """Serial small-field reader for headers (cheap, per-block)."""

    def __init__(self, buf: np.ndarray, bit_pos: int, bit_end: int):
        self.buf = buf
        self.pos = bit_pos
        self.end = bit_end

    def bits(self, n: int) -> int:
        if self.pos + n > self.end:
            raise NeedMoreInput
        lo = self.pos >> 3
        hi = (self.pos + n + 7) >> 3
        chunk = int.from_bytes(self.buf[lo:hi].tobytes(), "little")
        val = (chunk >> (self.pos & 7)) & ((1 << n) - 1)
        self.pos += n
        return val

    def align_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7


# --- dynamic header parsing -------------------------------------------------


def parse_dynamic_header(reader: BitReader, return_lengths: bool = False):
    """Parse HLIT/HDIST/HCLEN + code-length RLE into two decode LUTs.

    With return_lengths, also returns the (lit_lengths, dist_lengths)
    arrays (the canonical-decode device path needs lengths, not LUTs).
    Parity with reference src/infblocks.ts:334-523 (DTREE..DTREE states).
    """
    hlit, lengths = _parse_dynamic_rle(reader)
    try:
        lut_lit = huffman.build_lut(lengths[:hlit], "litlen")
        lut_dist = huffman.build_lut(lengths[hlit:], "dist")
    except huffman.TreeError as e:
        raise DataError(str(e))
    if return_lengths:
        return lut_lit, lut_dist, lengths[:hlit], lengths[hlit:]
    return lut_lit, lut_dist


def _parse_dynamic_rle(reader: BitReader):
    """Dynamic-header field + code-length RLE parse -> (hlit, lengths);
    raises on malformed headers (shared by the LUT and lengths-only
    entry points)."""
    hlit = reader.bits(5) + 257
    hdist = reader.bits(5) + 1
    hclen = reader.bits(4) + 4
    if hlit > 286 or hdist > 30:
        raise DataError("too many length or distance symbols")
    clc_lengths = np.zeros(19, dtype=np.int32)
    for i in range(hclen):
        clc_lengths[CLC_ORDER[i]] = reader.bits(3)
    try:
        clc_lut = huffman.build_lut(clc_lengths, "codelen")
    except huffman.TreeError:
        raise DataError("invalid code lengths set")

    lengths = np.zeros(hlit + hdist, dtype=np.int32)
    i = 0
    while i < hlit + hdist:
        # decode one code-length symbol: peek up to 7 bits (max CLC length)
        avail = reader.end - reader.pos
        peek_n = min(7, avail)
        lo = reader.pos >> 3
        hi = (reader.pos + peek_n + 7) >> 3
        chunk = int.from_bytes(reader.buf[lo:hi].tobytes(), "little")
        w = (chunk >> (reader.pos & 7)) & ((1 << peek_n) - 1)
        ent = int(clc_lut[w])
        if ent & huffman.INVALID:
            if avail < 7:
                raise NeedMoreInput
            raise DataError("invalid code lengths set")
        nb = (ent >> huffman.NB_SHIFT) & huffman.NB_MASK
        if nb > avail:
            raise NeedMoreInput
        sym = ent & huffman.VAL_MASK
        reader.pos += int(nb)
        if sym < 16:
            lengths[i] = sym
            i += 1
            continue
        if sym == 16:
            if i == 0:
                raise DataError("invalid bit length repeat")
            rep = 3 + reader.bits(2)
            fill = lengths[i - 1]
        elif sym == 17:
            rep = 3 + reader.bits(3)
            fill = 0
        else:  # sym == 18
            rep = 11 + reader.bits(7)
            fill = 0
        if i + rep > hlit + hdist:
            raise DataError("invalid bit length repeat")
        if fill:
            lengths[i : i + rep] = fill
        i += rep
    if lengths[256] == 0:
        raise DataError("invalid code -- missing end-of-block")
    return hlit, lengths


# --- vectorized segment decode ----------------------------------------------

#: exit kinds for a segment walk
EXIT_MORE = 0  # consumed everything decodable; need more input
EXIT_SEGMENT = 1  # crossed segment end with input remaining; continue
EXIT_EOB = 2  # end-of-block symbol consumed
EXIT_ERROR = 3

_U64_1 = np.uint64(1)
_U64_15MASK = np.uint64(0x7FFF)


def decode_positions(w: np.ndarray, lut_lit: np.ndarray, lut_dist: np.ndarray):
    """Decode a candidate token at every position given its 57-bit window.

    Pure vectorized core, shared shape with the device kernel.  Returns
    (litlen, dist, jump, flags) where flags bits: 1=EOB, 2=invalid.
    """
    ent = lut_lit[(w & _U64_15MASK).astype(np.int64)].astype(np.uint64)
    nb = (ent >> np.uint64(15)) & np.uint64(0xF)
    eb = (ent >> np.uint64(19)) & np.uint64(0xF)
    base = ent & _U64_15MASK
    extra = (w >> nb) & ((_U64_1 << eb) - _U64_1)
    val = (base + extra).astype(np.int32)
    jump1 = nb + eb
    is_len = (ent & np.uint64(1 << 23)) != 0
    is_eob = (ent & np.uint64(1 << 24)) != 0
    invalid = (ent >> np.uint64(31)) != 0

    dent = lut_dist[((w >> jump1) & _U64_15MASK).astype(np.int64)].astype(np.uint64)
    dnb = (dent >> np.uint64(15)) & np.uint64(0xF)
    deb = (dent >> np.uint64(19)) & np.uint64(0xF)
    dbase = dent & _U64_15MASK
    dextra = (w >> (jump1 + dnb)) & ((_U64_1 << deb) - _U64_1)
    dval = (dbase + dextra).astype(np.int32)
    dinvalid = (dent >> np.uint64(31)) != 0

    jump = np.where(is_len, jump1 + dnb + deb, jump1).astype(np.int32)
    dist = np.where(is_len, dval, 0)
    # flags: 1 = EOB, 2 = invalid literal/length code, 4 = invalid distance
    flags = (
        is_eob.astype(np.int8)
        | (invalid.astype(np.int8) << 1)
        | ((is_len & dinvalid).astype(np.int8) << 2)
    )
    return val, dist, jump, flags


def decode_segment(
    w64: np.ndarray,
    bit_pos: int,
    avail_bits: int,
    lut_lit: np.ndarray,
    lut_dist: np.ndarray,
    seg_bits: int,
):
    """Decode the token sequence starting at bit_pos within one block.

    Returns (litlen, dist, exit_kind, next_bit_pos)."""
    m = min(seg_bits, avail_bits - bit_pos)
    if m <= 0:
        return np.empty(0, np.int32), np.empty(0, np.int32), EXIT_MORE, bit_pos
    pos = np.arange(bit_pos, bit_pos + m, dtype=np.int64)
    w = w64[(pos >> 3)] >> (pos & 7).astype(np.uint64)

    litlen_tok, dist_tok, jump, flags = decode_positions(w, lut_lit, lut_dist)
    is_eob = (flags & 1) != 0
    bad = (flags & 6) != 0

    # --- jump graph with sentinels ---
    SENT_OUT = m  # target beyond segment / incomplete input
    SENT_EOB = m + 1
    SENT_ERR = m + 2
    tgt_rel = np.arange(m, dtype=np.int32) + jump
    consumable = tgt_rel <= avail_bits - bit_pos
    nxt = np.where(consumable, np.minimum(tgt_rel, SENT_OUT), np.int32(SENT_OUT))
    nxt = np.where(bad, np.int32(SENT_ERR), nxt)
    nxt = np.where(is_eob & ~bad & consumable, np.int32(SENT_EOB), nxt)

    # --- pointer-doubling path extraction from relative position 0 ---
    J = np.concatenate(
        [nxt, np.array([SENT_OUT, SENT_EOB, SENT_ERR], dtype=np.int32)]
    )
    reach = np.zeros(m + 3, dtype=bool)
    reach[0] = True
    steps = 1
    Jk = J
    while steps < m + 1:
        newly = Jk[np.flatnonzero(reach)]
        before = reach[newly]
        reach[newly] = True
        if not (~before).any():
            break
        Jk = Jk[Jk]
        steps <<= 1

    path = np.flatnonzero(reach[:m])
    p_last = path[-1]
    exit_sent = int(nxt[p_last])
    if exit_sent == SENT_ERR:
        if flags[p_last] & 2:
            raise DataError("invalid literal/length code")
        raise DataError("invalid distance code")
    if exit_sent == SENT_EOB:
        next_bit = bit_pos + int(tgt_rel[p_last])
        return litlen_tok[path[:-1]], dist_tok[path[:-1]], EXIT_EOB, next_bit
    # SENT_OUT: the token at p_last either crossed the segment end while
    # staying within available input (consume it) or ran out of input.
    if consumable[p_last] and not bad[p_last] and not is_eob[p_last]:
        next_bit = bit_pos + int(tgt_rel[p_last])
        exit_kind = EXIT_SEGMENT if next_bit < avail_bits else EXIT_MORE
        return litlen_tok[path], dist_tok[path], exit_kind, next_bit
    next_bit = bit_pos + int(p_last)
    return litlen_tok[path[:-1]], dist_tok[path[:-1]], EXIT_MORE, next_bit
