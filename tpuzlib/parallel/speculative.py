"""Speculative parallel inflate for ARBITRARY single-stream DEFLATE data
(no index, no sync points) — the codec's sequence parallelism
(SURVEY.md §5 "long-context" analog; rapidgzip-style, see PAPERS.md).

Why it works in this architecture: tokenization is window-free — a token
tape (literals + (len,dist) pairs) can be produced for any block without
knowing the previous 32 KiB of output.  So:

  1. DISCOVER: for each segment boundary, scan bit offsets for a
     plausible dynamic-block header (Kraft-valid code-length sets), then
     confirm by decoding a probe run of symbols without hitting invalid
     codes — false positives are culled cheaply;
  2. TOKENIZE: every segment tokenizes independently (vectorized
     tokenizer) in parallel;
  3. VALIDATE: segment token streams must chain — the bit position where
     segment i ends must equal segment i+1's discovered start, else the
     gap is re-tokenized sequentially (speculation miss);
  4. EXPAND: ONE global LZ resolution over the concatenated tape
     (codec/expand pointer doubling) — cross-segment back-references
     need no special handling at all.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..codec import tokenize as tk
from ..codec.expand import expand_host
from ..codec.huffman import fixed_dist_lut, fixed_litlen_lut


class SpeculationMiss(Exception):
    pass


def _native_tokenize_range(buf, start_bit, stop_bit):
    import ctypes

    try:
        from ..native.bindings import get_lib, native_available

        if not native_available():
            return None
        lib = get_lib()
    except Exception:  # pragma: no cover
        return None
    from ..native.api import _p32, _p8

    # tokens rarely exceed ~0.6 per compressed byte; grow on overflow
    span_bytes = max(1, (stop_bit - start_bit) // 8)
    cap = max(1 << 16, span_bytes)
    while True:
        litlen = np.empty(cap, np.int32)
        dist = np.empty(cap, np.int32)
        end_bit = ctypes.c_int64(0)
        finished = ctypes.c_int32(0)
        status = ctypes.c_int32(0)
        ntok = lib.tz_inflate_tokenize(
            _p8(buf), np.int64(len(buf)), np.int64(start_bit),
            np.int64(stop_bit), _p32(litlen), _p32(dist), np.int64(cap),
            ctypes.byref(end_bit), ctypes.byref(finished), ctypes.byref(status),
        )
        if status.value == 3:
            cap *= 4
            continue
        if status.value != 0:
            raise tk.DataError("invalid compressed data")
        return (
            litlen[:ntok].copy(),
            dist[:ntok].copy(),
            int(end_bit.value),
            bool(finished.value),
        )


def _probe_header(buf: np.ndarray, bit_pos: int, avail_bits: int,
                  allow_final: bool = False):
    """Try to parse a block header at bit_pos.  Returns (luts, data_start)
    or None."""
    reader = tk.BitReader(buf, bit_pos, avail_bits)
    try:
        last = reader.bits(1)
        btype = reader.bits(2)
        if last and not allow_final:
            # segment decoding treats final blocks as the tail's job
            return None
        if btype == 2:
            luts = tk.parse_dynamic_header(reader)
            return luts, reader.pos
        if btype == 1:
            return (fixed_litlen_lut(), fixed_dist_lut()), reader.pos
        return None
    except (tk.DataError, tk.NeedMoreInput):
        return None


def _confirm(w64, data_start, avail_bits, luts, probe_syms=48):
    """Decode a short run of symbols; reject if the path hits an invalid
    code quickly (false-positive header)."""
    try:
        litlen, dist, exit_kind, next_bit = tk.decode_segment(
            w64, data_start, avail_bits, luts[0], luts[1], 1 << 12
        )
    except tk.DataError:
        return False
    return len(litlen) >= min(probe_syms, 8)


def _kraft_prefilter(w64, start_bit: int, nbits: int,
                     allow_final: bool = False) -> np.ndarray:
    """Vectorized candidate filter for dynamic-block headers.

    For every bit offset in [start_bit, start_bit+nbits): BFINAL must be
    0, BTYPE must be 10, HLIT/HDIST/HCLEN in range, and the code-length
    code's Kraft sum must be exactly 2^7 (a complete CLC tree — the
    rapidgzip-style cheap reject).  Returns relative offsets of
    survivors.

    Two-stage (round 4): the cheap field checks kill ~98% of positions,
    so the 19-term Kraft sum runs on the survivors only; bit windows
    come from a byte-view broadcast, not a per-position gather."""
    first_byte = start_bit >> 3
    last_byte = (start_bit + nbits - 1) >> 3
    span = last_byte - first_byte + 1
    wbytes = w64[first_byte : first_byte + span]
    if len(wbytes) < span:  # buffer tail: zero-pad the window views
        wbytes = np.concatenate(
            [wbytes, np.zeros(span - len(wbytes), np.uint64)]
        )
    shifts = np.arange(8, dtype=np.uint64)
    # wA_all[b, s] = 64-bit window at bit (first_byte+b)*8 + s
    wA_all = (wbytes[:, None] >> shifts[None, :]).reshape(-1)
    lo = start_bit - first_byte * 8
    wA = wA_all[lo : lo + nbits]

    btype = ((wA >> np.uint64(1)) & np.uint64(3)).astype(np.int32)
    hlit = ((wA >> np.uint64(3)) & np.uint64(31)).astype(np.int32)
    hdist = ((wA >> np.uint64(8)) & np.uint64(31)).astype(np.int32)
    ok = (btype == 2) & (hlit <= 29) & (hdist <= 29)
    if not allow_final:
        ok &= (wA & np.uint64(1)) == 0
    cand = np.flatnonzero(ok)
    if len(cand) == 0:
        return cand

    wAc = wA[cand]
    posB = cand + np.int64(start_bit) + 40
    wBc = w64[np.minimum(posB >> 3, len(w64) - 1)] >> (posB & 7).astype(
        np.uint64
    )
    hclen = ((wAc >> np.uint64(13)) & np.uint64(15)).astype(np.int64) + 4
    kraft = np.zeros(len(cand), dtype=np.int64)
    nzero = np.zeros(len(cand), dtype=np.int64)
    for j in range(19):
        o = 17 + 3 * j
        if o + 3 <= 57:
            lj = ((wAc >> np.uint64(o)) & np.uint64(7)).astype(np.int64)
        else:
            lj = ((wBc >> np.uint64(o - 40)) & np.uint64(7)).astype(np.int64)
        used = (j < hclen) & (lj > 0)
        kraft += np.where(used, 1 << (7 - np.minimum(lj, 7)), 0)
        nzero += used
    return cand[(kraft == 128) & (nzero >= 2)]


def _native_probe(buf: np.ndarray, bit_pos: int) -> bool | None:
    """Probe+confirm a candidate header with ONE bounded native call
    (~us, vs ~0.5 ms for the python parse + LUT build): ask the native
    tokenizer to decode from the claimed header with a tiny token cap —
    cap-overflow (status 3) or clean completion means a real header
    decoded ≥tens of symbols.  Returns None when the native lib is
    unavailable (caller falls back to the python probe)."""
    import ctypes

    try:
        from ..native.bindings import get_lib, native_available

        if not native_available():
            return None
        lib = get_lib()
    except Exception:  # pragma: no cover
        return None
    from ..native.api import _p32, _p8

    cap = 64
    litlen = np.empty(cap, np.int32)
    dist = np.empty(cap, np.int32)
    end_bit = ctypes.c_int64(0)
    finished = ctypes.c_int32(0)
    status = ctypes.c_int32(0)
    ntok = lib.tz_inflate_tokenize(
        _p8(buf), np.int64(len(buf)), np.int64(bit_pos),
        np.int64(bit_pos + 1), _p32(litlen), _p32(dist), np.int64(cap),
        ctypes.byref(end_bit), ctypes.byref(finished), ctypes.byref(status),
    )
    if status.value == 3:
        return True  # cap overflow: header + >=64 symbols decoded
    # clean parse of >=8 symbols, or clean parse straight through the
    # final EOB (tiny final blocks; keep in sync with tz_find_headers)
    return status.value == 0 and (ntok >= 8 or finished.value != 0)


def find_all_block_starts(buf: np.ndarray, from_bit: int = 0,
                          allow_final: bool = True) -> list:
    """One full-stream header scan: native branchy bit scan with Kraft
    prefilter + bounded-decode confirmation (tz_find_headers), falling
    back to the vectorized numpy prefilter + per-candidate probes.

    Replaces the per-block find_block_start loop in block planning —
    that repeated scan plus python probes was the bottleneck of the
    device inflate's block plan; the planner just consumes this one
    pass."""
    import ctypes

    try:
        from ..native.bindings import get_lib, native_available

        if native_available():
            lib = get_lib()
            cap = 4096
            while True:
                pos = np.empty(cap, np.int64)
                n = lib.tz_find_headers(
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    np.int64(len(buf)), np.int64(from_bit),
                    np.int32(1 if allow_final else 0),
                    pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    np.int64(cap),
                )
                if n < cap:
                    return pos[:n].tolist()
                cap *= 8
    except Exception:  # pragma: no cover - fall through to numpy path
        pass

    avail_bits = len(buf) * 8
    w64 = tk.byte_windows64(buf)
    out = []
    CHUNK = 1 << 23  # bits
    bit = from_bit
    while bit < avail_bits:
        nbits = min(CHUNK, avail_bits - bit)
        for rel in _kraft_prefilter(w64, bit, nbits, allow_final=allow_final):
            p = bit + int(rel)
            got = _native_probe(buf, p)
            if got is None:
                pr = _probe_header(buf, p, avail_bits, allow_final=allow_final)
                got = pr is not None and _confirm(w64, pr[1], avail_bits, pr[0])
            if got:
                out.append(p)
        bit += nbits
    return out


def find_block_start(buf: np.ndarray, from_byte: int, window_bytes: int = 1 << 15,
                     allow_final: bool = False):
    """Scan forward from from_byte for a confirmed block-header bit
    offset.  Returns bit position or None.

    Builds bit windows only over the scanned region + a confirmation
    margin (never the whole buffer)."""
    avail_bits = len(buf) * 8
    region_end = min(len(buf), from_byte + window_bytes + (1 << 13))
    local = tk.byte_windows64(buf[from_byte:region_end])
    local_bits = (region_end - from_byte) * 8
    limit_bits = min(local_bits, window_bytes * 8)
    if limit_bits <= 0:
        return None
    for rel in _kraft_prefilter(local, 0, limit_bits, allow_final=allow_final):
        lpos = int(rel)
        got = _probe_header(
            buf[from_byte:region_end], lpos, local_bits, allow_final=allow_final
        )
        if got is None:
            continue
        luts, data_start = got
        if _confirm(local, data_start, local_bits, luts):
            return from_byte * 8 + lpos
    return None


def _tokenize_range(buf, w64, start_bit, stop_bit, avail_bits):
    """Tokenize blocks from start_bit until a block ends at/after
    stop_bit (or the stream's final block).  Returns
    (litlen, dist, end_bit, finished).

    Uses the GIL-free native tokenizer when available (real thread
    scaling); the vectorized numpy path is the fallback."""
    native = _native_tokenize_range(buf, start_bit, stop_bit)
    if native is not None:
        return native
    if w64 is None:
        w64 = tk.byte_windows64(buf)

    bit_pos = start_bit
    chunks = []
    finished = False
    while True:
        reader = tk.BitReader(buf, bit_pos, avail_bits)
        try:
            last = reader.bits(1)
            btype = reader.bits(2)
            if btype == 0:
                reader.align_byte()
                length = reader.bits(16)
                nlen = reader.bits(16)
                if length != (~nlen & 0xFFFF):
                    raise tk.DataError("invalid stored block lengths")
                byte_pos = reader.pos >> 3
                chunk = buf[byte_pos : byte_pos + length]
                chunks.append(
                    (chunk.astype(np.int32), np.zeros(len(chunk), np.int32))
                )
                bit_pos = (byte_pos + length) * 8
            else:
                if btype == 1:
                    luts = (fixed_litlen_lut(), fixed_dist_lut())
                elif btype == 2:
                    luts = tk.parse_dynamic_header(reader)
                else:
                    raise tk.DataError("invalid block type")
                bit_pos = reader.pos
                while True:
                    litlen, dist, exit_kind, bit_pos = tk.decode_segment(
                        w64, bit_pos, avail_bits, luts[0], luts[1], 1 << 19
                    )
                    if len(litlen):
                        chunks.append((litlen, dist))
                    if exit_kind == tk.EXIT_EOB:
                        break
                    if exit_kind == tk.EXIT_MORE:
                        raise tk.DataError("unexpected end of stream")
            if last:
                finished = True
                break
        except tk.NeedMoreInput:
            raise tk.DataError("unexpected end of stream")
        if bit_pos >= stop_bit:
            break
    if chunks:
        litlen = np.concatenate([c[0] for c in chunks])
        dist = np.concatenate([c[1] for c in chunks])
    else:
        litlen = np.empty(0, np.int32)
        dist = np.empty(0, np.int32)
    return litlen, dist, bit_pos, finished


def inflate_parallel(
    data,
    n_segments: int | None = None,
    max_workers: int | None = None,
    dictionary: np.ndarray | None = None,
) -> np.ndarray:
    """Decode a raw DEFLATE stream with speculative segment parallelism.

    Falls back to sequential tokenization for any segment whose
    speculation misses (wrong discovered boundary)."""
    import os

    buf = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    from ..native.bindings import native_available

    w64 = None if native_available() else tk.byte_windows64(buf)
    avail_bits = len(buf) * 8
    if n_segments is None:
        n_segments = max(
            1, min(len(os.sched_getaffinity(0)), len(buf) // (1 << 16))
        )

    # 1. discover candidate starts
    bounds = [0]
    for s in range(1, n_segments):
        target = len(buf) * s // n_segments
        found = find_block_start(buf, target)
        if found is not None and (not bounds or found > bounds[-1]):
            bounds.append(found)
    stops = bounds[1:] + [avail_bits]

    # 2. tokenize segments in parallel
    def work(args):
        start, stop = args
        return _tokenize_range(buf, w64, start, stop, avail_bits)

    if max_workers is None:
        from ..codec.deflate_engine import get_executor

        results = list(get_executor().map(work, zip(bounds, stops)))
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            results = list(ex.map(work, zip(bounds, stops)))

    # 3. validate the chain; re-tokenize any mis-speculated gap
    tapes = [results[0]]
    for i in range(1, len(results)):
        prev_end = tapes[-1][2]
        if prev_end == bounds[i]:
            tapes.append(results[i])
        else:
            # speculation miss: decode from the true position up to the
            # next verified boundary (or the end)
            litlen, dist, end_bit, fin = _tokenize_range(
                buf, w64, prev_end, stops[i], avail_bits
            )
            tapes.append((litlen, dist, end_bit, fin))
    if not tapes[-1][3]:
        # keep decoding to the stream's final block
        litlen, dist, end_bit, fin = _tokenize_range(
            buf, w64, tapes[-1][2], avail_bits, avail_bits
        )
        if not fin:
            raise tk.DataError("unexpected end of stream")
        tapes.append((litlen, dist, end_bit, fin))

    # 4. one global expansion resolves all back-references
    litlen = np.concatenate([t[0] for t in tapes])
    dist = np.concatenate([t[1] for t in tapes])
    window = (
        # inflate dictionaries clip to the last 32K-1 bytes
        # (inflate.ts:489-492)
        dictionary[-((1 << 15) - 1):].astype(np.uint8)
        if dictionary is not None and len(dictionary)
        else np.empty(0, np.uint8)
    )
    return expand_host(litlen, dist, window)


def inflate_parallel_container(data, n_segments=None, max_workers=None,
                               dictionary=None, verify=True):
    """Container-aware speculative decompression (zlib/gzip/raw
    auto-detect, trailer checksum verification)."""
    from ..common import u8_view
    from ..containers.inflate_container import ContainerInflater

    view = u8_view(data)
    if len(view) < 2:
        raise ValueError("data buffer is too small")
    b0, b1 = int(view[0]), int(view[1])
    if b0 == 0x1F and b1 == 0x8B:
        c = ContainerInflater(raw=False)
        consumed = c._try_parse_gzip_header(view)
        if consumed is None:
            raise ValueError("inflate error: truncated gzip header")
        payload = view[consumed:-8]
        import struct

        stored_crc, isize = struct.unpack("<II", view[-8:].tobytes())
        out = inflate_parallel(payload, n_segments, max_workers, dictionary)
        if verify:
            from ..api.checksums import crc32

            if crc32(out) != stored_crc or (len(out) & 0xFFFFFFFF) != isize:
                raise ValueError("Data integrity check failed")
        return out
    if (b0 & 0x0F) == 8 and (b0 >> 4) <= 7 and ((b0 << 8) + b1) % 31 == 0:
        hdr = 2
        if b1 & 0x20:  # FDICT: verify DICTID exactly like the standard
            # path (inflate.ts:475-503) — the parallel dispatch must not
            # change NEED_DICT semantics with core count
            if len(view) < 6:
                raise ValueError("data buffer is too small")
            import struct as _s

            dict_id = _s.unpack(">I", view[2:6].tobytes())[0]
            if dictionary is None:
                raise ValueError("Custom dictionary required for this data")
            from ..api.checksums import adler32 as _adler

            if _adler(np.ascontiguousarray(u8_view(dictionary))) != dict_id:
                raise ValueError("Custom dictionary is not valid for this data")
            hdr = 6
        payload = view[hdr:-4]
        import struct

        stored_adler = struct.unpack(">I", view[-4:].tobytes())[0]
        out = inflate_parallel(payload, n_segments, max_workers, dictionary)
        if verify:
            from ..api.checksums import adler32

            if adler32(out) != stored_adler:
                raise ValueError("Data integrity check failed")
        return out
    return inflate_parallel(view, n_segments, max_workers, dictionary)
