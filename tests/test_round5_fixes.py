"""Regression tests for earlier review findings.

* The device tokenizer must reject INVALID distance entries (fixed-tree
  dist codes 30/31) instead of decoding them as dist=0 matches — 'never
  silently keep garbage tokens'.
* Option types exported at package root (parity with reference
  src/sd-zlib.ts:39-43 export surface).
* Device dispatch is opt-in (TPUZLIB_DEVICE=1) — the default public API
  never routes to an unmeasured device path.
"""

import zlib

import numpy as np
import pytest

import tpuzlib
from tpuzlib import corpus


class _BitWriter:
    """LSB-first DEFLATE bit stream; Huffman codes emitted MSB-first."""

    def __init__(self):
        self.bits = []

    def lsb(self, value, n):
        for i in range(n):
            self.bits.append((value >> i) & 1)

    def code(self, value, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def bytes(self):
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out)


def _fixed_lit(sym):
    """(code, nbits) for a fixed-tree litlen symbol (RFC 1951 3.2.6)."""
    if sym <= 143:
        return 0x30 + sym, 8
    if sym <= 255:
        return 0x190 + (sym - 144), 9
    if sym <= 279:
        return sym - 256, 7
    return 0xC0 + (sym - 280), 8


def _invalid_dist_stream():
    """Fixed-Huffman raw DEFLATE block: literals, then a length code
    followed by the RESERVED distance code 30 (valid 5-bit canonical
    code, forbidden by RFC 1951 3.2.6 / inftree.ts INVALID entries)."""
    w = _BitWriter()
    w.lsb(1, 1)  # BFINAL
    w.lsb(1, 2)  # BTYPE=01 fixed
    for ch in b"abcdabcd":
        c, n = _fixed_lit(ch)
        w.code(c, n)
    c, n = _fixed_lit(257)  # length 3
    w.code(c, n)
    w.code(30, 5)  # reserved distance code — invalid
    w.lsb(0, 13)  # its nominal extra bits (never legal)
    for ch in b"xyz":
        c, n = _fixed_lit(ch)
        w.code(c, n)
    c, n = _fixed_lit(256)  # EOB
    w.code(c, n)
    return w.bytes()


def test_reserved_dist_code_rejected_everywhere():
    """zlib calls this stream 'invalid distance code'; every tpuzlib
    path must refuse it (device paths fall back to None, host raises)."""
    raw = _invalid_dist_stream()
    with pytest.raises(zlib.error):
        zlib.decompressobj(-15).decompress(raw)

    from tpuzlib.kernels.inflate_device2 import inflate_device_v2

    payload = np.frombuffer(raw, np.uint8)
    assert inflate_device_v2(payload) is None
    # host engine parity
    inf = tpuzlib.Inflater(tpuzlib.InflaterOptions(raw=True))
    with pytest.raises(ValueError):
        inf.append(raw)


def _tiny_dynamic_final_block():
    """One FINAL dynamic block carrying only 4 symbols (AAA + EOB) —
    fewer than the 8-symbol confirmation floor."""
    w = _BitWriter()
    w.lsb(1, 1)  # BFINAL
    w.lsb(2, 2)  # BTYPE=10 dynamic
    w.lsb(0, 5)  # HLIT -> 257 litlen codes
    w.lsb(0, 5)  # HDIST -> 1 dist code
    w.lsb(14, 4)  # HCLEN -> 18 CLC entries
    clc = {17: 2, 18: 2, 0: 2, 1: 2}
    order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1]
    for s in order:
        w.lsb(clc.get(s, 0), 3)
    code = {0: 0b00, 1: 0b01, 17: 0b10, 18: 0b11}
    # litlen lengths: 65 zeros, len-1 ('A'), 190 zeros, len-1 (EOB)
    w.code(code[18], 2); w.lsb(65 - 11, 7)
    w.code(code[1], 2)
    w.code(code[18], 2); w.lsb(138 - 11, 7)
    w.code(code[18], 2); w.lsb(52 - 11, 7)
    w.code(code[1], 2)
    w.code(code[1], 2)  # the single dist length (incomplete tree, legal)
    for bit in (0, 0, 0, 1):  # 'A','A','A', EOB
        w.code(bit, 1)
    return w.bytes()


def test_find_headers_tiny_final_block():
    """A clean bounded parse through the final EOB confirms a header even
    when the block holds fewer than 8 symbols (native + python probes)."""
    raw = _tiny_dynamic_final_block()
    assert zlib.decompressobj(-15).decompress(raw) == b"AAA"
    buf = np.frombuffer(raw, np.uint8)
    from tpuzlib.parallel.speculative import (
        _native_probe,
        find_all_block_starts,
    )

    starts = find_all_block_starts(buf, 0, allow_final=True)
    assert 0 in list(np.asarray(starts).ravel())
    probe = _native_probe(buf, 0)
    assert probe is None or probe is True  # None: native lib unavailable


def test_ext_cap_overflow_counter(monkeypatch):
    """TPUZLIB_TRACE_EXT=1 at program-build time routes the residual-
    extension cap overflow count into the trace counters."""
    monkeypatch.setenv("TPUZLIB_TRACE_EXT", "1")
    from tpuzlib.utils import trace
    from tpuzlib.kernels.deflate_device3 import CTX, make_encode_batch_v3

    trace.reset_counters()
    import jax.numpy as jnp

    chunk, batch = 1 << 12, 1  # fresh shape -> fresh trace-time build
    out_words = min(chunk + 4, (chunk * 10) // 32 + 64)
    enc = make_encode_batch_v3(6, chunk, batch, out_words)
    txt = corpus.artifact("paradiselost.txt")
    buf = np.zeros((batch, CTX + chunk), np.uint8)
    buf[0, CTX:] = np.frombuffer(txt[:chunk], np.uint8)
    w, tb, ok = enc(
        jnp.asarray(buf),
        jnp.zeros(batch, jnp.int32),
        jnp.full(batch, chunk, jnp.int32),
        jnp.ones(batch, jnp.int32),
    )
    np.asarray(w)
    assert "deflate.ext_cap_overflow" in trace.get_counters()


def test_repair_bridge_cap_bounds_worst_case(monkeypatch):
    """The splice repair is budget-capped.  A stream with stored runs
    hidden behind Huffman blocks needs >=1 repair bridge (early in-block
    EOB; spurious-garbage EOBs continue as flagged tokens and do not
    bridge); with the bridge cap at 0 the repair must decline ONCE
    (graceful full fallback + counter), never storm the device with row
    pulls."""
    import zlib as _z

    from tpuzlib.kernels.inflate_device2 import inflate_device_v2
    from tpuzlib.utils import trace

    txt = corpus.artifact("paradiselost.txt")
    rng = np.random.default_rng(5)
    src = (
        txt[:150000]
        + rng.integers(0, 256, 120000, dtype=np.uint8).tobytes()
        + b"\x00" * 50000
        + txt[:100000]
    )
    wire = _z.compress(src, 6)
    payload = np.frombuffer(wire[2:-4], np.uint8)

    trace.reset_counters()
    out = inflate_device_v2(payload, size_hint=len(src) + 1024)
    assert out is not None and bytes(out) == src
    c = trace.get_counters()
    assert c.get("inflate.repair_bridge", 0) >= 1  # bridges are counted

    monkeypatch.setenv("TPUZLIB_REPAIR_MAX_BRIDGES", "0")
    trace.reset_counters()
    out = inflate_device_v2(payload, size_hint=len(src) + 1024)
    assert out is None  # declined, not corrupted
    assert trace.get_counters().get("inflate.repair_cap_exceeded", 0) == 1


def test_bridge_overshoot_sync_guard(monkeypatch):
    """Regression: a bridge chunk that decodes past the sync
    target's own boundary cut must NOT sync there (the next cursor's
    entry would sit before the bridge end -> duplicated tokens; caught
    as a checksum mismatch on v3-deflate streams through the public
    API).  Forcing huge bridge chunks makes every bridge overshoot; the
    sync guard (ii < jstop[k2]) must keep the output exact."""
    monkeypatch.setenv("TPUZLIB_BRIDGE_CHUNK", "100000")
    from tpuzlib.kernels.inflate_device2 import inflate_device_v2

    txt = corpus.artifact("paradiselost.txt")
    src = (txt * 2)[: 1 << 20]
    wire = bytes(tpuzlib.deflate(src, level=6))  # stream with >=1 bridge
    out = inflate_device_v2(
        np.frombuffer(wire[2:-4], np.uint8), size_hint=len(src) + 1024
    )
    assert out is None or bytes(out) == src  # never corrupt


def test_device_mismatch_falls_back_to_host(monkeypatch):
    """Dispatch rule: a device-path checksum mismatch re-decodes
    on the HOST for the authoritative verdict instead of raising — a
    device speculation fault must never surface as a false 'Data
    integrity check failed' on a valid stream."""
    monkeypatch.setenv("TPUZLIB_DEVICE", "0")
    txt = corpus.artifact("paradiselost.txt")
    src = (txt * 3)[: 1 << 20]
    wire = bytes(tpuzlib.deflate(src, level=6))
    monkeypatch.setenv("TPUZLIB_DEVICE", "1")
    import tpuzlib.api.inflate_api as api
    import tpuzlib.kernels.inflate_device2 as idv
    from tpuzlib.utils import trace

    def corrupt_device(*a, **k):
        out = np.frombuffer(src, np.uint8).copy()
        out[100] ^= 0xFF  # wrong bytes from the "device"
        return out

    monkeypatch.setattr(api, "inflate_device_v2", corrupt_device,
                        raising=False)
    monkeypatch.setattr(idv, "inflate_device_v2", corrupt_device)
    trace.reset_counters()
    out = tpuzlib.inflate(wire)  # host fallback must settle it
    assert bytes(out) == src
    assert trace.get_counters().get(
        "inflate.device_mismatch_fallback", 0
    ) == 1


def test_v3_stream_decodes_on_device_inflate():
    """Cross-path coverage: streams produced by the v3 DEVICE deflate
    must decode through the DEVICE inflate (the public-API device path
    whose integrity check caught the bridge-overshoot bug)."""
    from tpuzlib.kernels.deflate_device3 import deflate_device_v3
    from tpuzlib.kernels.inflate_device2 import inflate_device_v2

    txt = corpus.artifact("paradiselost.txt")
    src = txt[: 200000]
    body = bytes(
        deflate_device_v3(
            np.frombuffer(src, np.uint8), level=6, chunk=1 << 16, batch=2
        )
    )
    assert zlib.decompress(body, -15) == src
    out = inflate_device_v2(
        np.frombuffer(body, np.uint8), size_hint=len(src) + 1024,
        stride_bits=1 << 13, max_cursors=256,
    )
    assert out is None or bytes(out) == src
    assert out is not None, "device inflate declined a healthy v3 stream"


def test_option_types_exported_at_root():
    assert "InflaterOptions" in tpuzlib.__all__
    assert "DeflaterOptions" in tpuzlib.__all__
    opts = tpuzlib.InflaterOptions(raw=True)
    assert tpuzlib.Inflater(opts) is not None
    dopts = tpuzlib.DeflaterOptions(level=3, format="gzip")
    assert tpuzlib.Deflater(dopts).level == 3


def test_device_dispatch_off_by_default(monkeypatch):
    """Without TPUZLIB_DEVICE=1 the one-shot APIs stay on the host
    engine regardless of backend (no measured crossover yet)."""
    monkeypatch.delenv("TPUZLIB_DEVICE", raising=False)
    from tpuzlib.utils import trace

    trace.reset_counters()
    txt = corpus.artifact("paradiselost.txt")
    src = (txt * 5)[: 1 << 21]
    wire = bytes(tpuzlib.deflate(src, level=6))
    out = tpuzlib.inflate(wire)
    assert bytes(out) == src
    c = trace.get_counters()
    assert c.get("deflate.device", 0) == 0
    assert c.get("inflate.device", 0) == 0
