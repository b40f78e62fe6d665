"""Native (C++) component tests: parity with the vectorized reference
paths, truncation semantics, and threading."""

import zlib

import numpy as np
import pytest

from tpuzlib import corpus
from tpuzlib.native.bindings import native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library unavailable"
)


def test_native_inflate_matches_zlib(rng, paradiselost):
    from tpuzlib.native import api

    wire = np.frombuffer(zlib.compress(paradiselost, 6)[2:-4], np.uint8)
    out, consumed, status = api.inflate_raw(wire)
    assert status == api.STATUS_OK
    assert bytes(out) == paradiselost


def test_native_inflate_stream_resume(paradiselost):
    """Truncated input suspends at symbol granularity; the persistent
    stream state resumes exactly where it stopped (native analog of the
    reference's suspend/resume contract)."""
    from tpuzlib.native import api

    wire = np.frombuffer(zlib.compress(paradiselost, 6)[2:-4], np.uint8)
    stream = api.InflateStream()
    produced = b""
    pos_bits = 0
    status = None
    for frac in (3, 2, 1):  # grow the visible prefix: 1/3, 1/2, all
        visible = wire[: len(wire) // frac] if frac > 1 else wire
        window = np.frombuffer(produced[-32768:], np.uint8)
        out, consumed, status = stream.push(visible, pos_bits, window)
        produced += bytes(out)
        assert produced == paradiselost[: len(produced)]
        pos_bits = int(consumed)
    assert status == api.STATUS_OK
    assert produced == paradiselost


def test_native_inflate_truncation_partial_output(paradiselost):
    from tpuzlib.native import api

    wire = np.frombuffer(zlib.compress(paradiselost, 6)[2:-4], np.uint8)
    out, consumed, status = api.inflate_raw(wire[: len(wire) // 2])
    assert status == api.STATUS_NEED_MORE
    assert bytes(out) == paradiselost[: len(out)] and len(out) > 0


def test_native_tokenize_expands_correctly(rng, paradiselost):
    from tpuzlib.codec.expand import expand_host
    from tpuzlib.native import api

    data = np.frombuffer(paradiselost, np.uint8)
    for level in (1, 6, 9):
        ll, dd = api.tokenize(data, 0, level)
        assert bytes(expand_host(ll, dd, np.empty(0, np.uint8))) == paradiselost


def test_native_tokenize_with_context(paradiselost):
    """Matches must reach into the context prefix (halo semantics)."""
    from tpuzlib.codec.expand import expand_host
    from tpuzlib.native import api

    data = np.frombuffer(paradiselost[:80000], np.uint8)
    ctx_len = 32768
    ll, dd = api.tokenize(data, ctx_len, 6)
    out = expand_host(ll, dd, data[:ctx_len])
    assert bytes(out) == paradiselost[ctx_len:80000]
    assert int(dd.max()) > 0


def test_forced_numpy_path_equivalence(paradiselost, monkeypatch):
    """With native disabled the public API must behave identically."""
    import tpuzlib
    from tpuzlib.native import bindings

    wire_native = bytes(tpuzlib.deflate(paradiselost[:100000], level=6))
    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_tried", True)
    wire_numpy = bytes(tpuzlib.deflate(paradiselost[:100000], level=6))
    assert zlib.decompress(wire_native) == paradiselost[:100000]
    assert zlib.decompress(wire_numpy) == paradiselost[:100000]
    out = tpuzlib.inflate(wire_native)
    assert bytes(out) == paradiselost[:100000]


def test_parallel_one_shot_large(rng):
    import tpuzlib

    base = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    text = (b"some repeated phrases keep appearing here " * 40000)[: 1 << 20]
    data = base + text + base[: 1 << 19] + text[: 1 << 19]
    wire = tpuzlib.deflate(data, level=6)
    assert zlib.decompress(bytes(wire)) == data
    assert len(wire) <= len(zlib.compress(data, 6))
    assert bytes(tpuzlib.inflate(wire)) == data


def test_parallel_mixed_content_stored_alignment(rng):
    """Regression: stored blocks inside parallel chunks must stay
    byte-aligned in the JOINED stream (sync-flush chunk boundaries), and
    adaptive block splitting must keep mixed text|random corpora at or
    below zlib's size."""
    import tpuzlib

    txt = corpus.artifact("paradiselost.txt")
    data = (txt + rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()) * 4
    wire = tpuzlib.deflate(data, level=6)
    assert zlib.decompress(bytes(wire)) == data
    assert len(wire) <= len(zlib.compress(data, 6))
    assert bytes(tpuzlib.inflate(wire)) == data


def test_emit_chunk_c_parity_with_numpy_emit(rng, paradiselost):
    """tz_emit_chunk (whole-chunk C emit) decodes byte-exact and stays
    within a few bytes of the numpy emit path on varied content."""
    from tpuzlib.codec.bitsink import BitSink
    from tpuzlib.codec.deflate_blocks import emit_block_adaptive, emit_stored
    from tpuzlib.codec.emit_native import emit_chunk_c, tokenize_full

    cases = [
        paradiselost[:200_000],
        rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),  # stored wins
        paradiselost[:80_000] + rng.integers(0, 256, 80_000, dtype=np.uint8).tobytes(),
        b"a" * 50_000,
        b"xy",
        b"",
    ]
    for level in (1, 6, 9):
        for payload in cases:
            d = np.frombuffer(payload, np.uint8)
            litlen, dist, lf, df, soe = tokenize_full(d, 0, level)
            for last in (True, False):
                out = emit_chunk_c(litlen, dist, lf, df, soe, d, last, not last)
                do = zlib.decompressobj(-15)
                dec = do.decompress(bytes(out))
                assert dec == payload
                if last:
                    assert do.eof
            # size sanity vs the numpy emitter (same trees, same splits)
            sink = BitSink()
            if len(litlen):
                emit_block_adaptive(sink, litlen, dist, d, True)
            else:
                from tpuzlib.codec.deflate_blocks import emit_block

                emit_block(sink, litlen, dist, d, True)
            ref, _, _ = sink.flush(final=True)
            c_out = emit_chunk_c(litlen, dist, lf, df, soe, d, True, False)
            assert len(c_out) <= len(ref) + 64


def test_emit_chunk_c_max_distance_and_length(rng):
    """dist=32768 / len=258 tokens survive the C emit round trip at every
    block format (regression: fixed-tree table typo)."""
    from tpuzlib.codec.emit_native import emit_chunk_c, tokenize_full

    block = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    payload = block + bytes(31768) + block + b"z" * 300
    d = np.frombuffer(payload, np.uint8)
    for level in (1, 9):
        litlen, dist, lf, df, soe = tokenize_full(d, 0, level)
        out = emit_chunk_c(litlen, dist, lf, df, soe, d, True, False)
        assert zlib.decompressobj(-15).decompress(bytes(out)) == payload
