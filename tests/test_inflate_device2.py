"""Cursor-parallel device inflate (kernels/inflate_device2).

Runs on the CPU backend (conftest); the same jit programs serve the GPU.
Oracle: python-zlib compressed streams and our own engine's streams.
"""

import zlib

import numpy as np
import pytest

import tpuzlib
from tpuzlib import corpus
from tpuzlib.kernels.inflate_device2 import inflate_device_v2, _plan_blocks


def _raw(payload):
    return np.ascontiguousarray(np.frombuffer(payload, np.uint8))


def test_plan_discovers_all_blocks(paradiselost):
    wire = bytes(tpuzlib.deflate(paradiselost, level=6))
    plan = _plan_blocks(_raw(wire[2:-4]))
    assert plan is not None
    assert plan[-1][4] is True  # final block found (BFINAL)
    assert not any(p[5] for p in plan)  # no open ends


def test_cursor_plan_fits_many_blocks(paradiselost):
    """A stream of many short blocks: the plan's one stride choice keeps
    every block's rounded-up cursor count inside the budget."""
    from tpuzlib.kernels.inflate_device2 import _cursor_plan

    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    parts = [c.compress(paradiselost[i : i + 3000]) + c.flush(zlib.Z_FULL_FLUSH)
             for i in range(0, 240000, 3000)]
    raw = _raw(b"".join(parts) + c.flush())
    nblocks = len(_plan_blocks(raw))
    assert nblocks >= 80
    cp = _cursor_plan(raw, 1 << 12, 128)
    assert cp is not None and nblocks <= cp.K <= 128
    assert cp.stride_bits % 4096 == 0
    out = inflate_device_v2(raw, stride_bits=1 << 12, max_cursors=128)
    assert out is not None and bytes(out) == paradiselost[:240000]


@pytest.mark.parametrize("device_expand", [True, False])
def test_roundtrip_own_stream(paradiselost, device_expand):
    wire = bytes(tpuzlib.deflate(paradiselost, level=6))
    out = inflate_device_v2(
        _raw(wire[2:-4]), stride_bits=1 << 14, max_cursors=256,
        device_expand=device_expand,
    )
    assert out is not None and bytes(out) == paradiselost


def test_spurious_eob_no_longer_needs_repair(paradiselost, monkeypatch):
    """A 1 MiB stream with thousands of speculative cursor starts: a
    spurious EOB decoded in a cursor's speculation garbage is recorded
    as a flagged tape token and decoding continues, so the cursor
    self-syncs and the FAST splice path handles the stream — no repair
    at all."""
    monkeypatch.setenv("TPUZLIB_DEBUG_INFLATE", "")
    src = (paradiselost * 2)[: 1 << 20]
    wire = bytes(tpuzlib.deflate(src, level=6))
    from tpuzlib.utils import trace

    before = trace.get_counters().get("inflate.splice_repair", 0)
    out = inflate_device_v2(_raw(wire[2:-4]), size_hint=len(src) + 1024)
    assert out is not None and bytes(out) == src
    assert trace.get_counters().get("inflate.splice_repair", 0) == before


def test_splice_repair_forced_matches_fast_path(paradiselost, monkeypatch):
    """Forced repair on healthy streams must reproduce the fast path's
    bytes exactly (covers the host keep-bounds walk + compaction)."""
    src = paradiselost[: 1 << 18]
    wire = bytes(tpuzlib.deflate(src, level=6))
    fast = inflate_device_v2(_raw(wire[2:-4]), size_hint=len(src) + 1024)
    assert fast is not None and bytes(fast) == src
    monkeypatch.setenv("TPUZLIB_FORCE_REPAIR", "1")
    rep = inflate_device_v2(_raw(wire[2:-4]), size_hint=len(src) + 1024)
    assert rep is not None and bytes(rep) == src
    # stored blocks + sync gaps through the forced-repair path too
    rng = np.random.default_rng(9)
    mixed = (
        paradiselost[: 1 << 16]
        + rng.integers(0, 256, 1 << 15).astype(np.uint8).tobytes()
        + paradiselost[: 1 << 15]
    )
    zc = bytes(tpuzlib.deflate(mixed, level=6))
    rep = inflate_device_v2(_raw(zc[2:-4]), size_hint=len(mixed) + 1024)
    assert rep is not None and bytes(rep) == mixed


def test_v3_stream_fuzz(paradiselost, monkeypatch):
    """Streams from the v3 DEVICE encoder (different block geometry than
    zlib: few big blocks) through the device inflate, across chunk
    sizes and bridge-chunk sizes — a bridge-overshoot bug once lived
    exactly in this cross-path corner."""
    import zlib as _z

    from tpuzlib.kernels.deflate_device3 import deflate_device_v3

    rng = np.random.default_rng(17)
    for trial in range(4):
        n = int(rng.integers(120000, 260000))
        off = int(rng.integers(0, len(paradiselost) - n))
        src = paradiselost[off : off + n]
        body = bytes(
            deflate_device_v3(
                np.frombuffer(src, np.uint8), level=6,
                chunk=1 << 16, batch=2,
            )
        )
        assert _z.decompress(body, -15) == src
        monkeypatch.setenv(
            "TPUZLIB_BRIDGE_CHUNK", str(int(rng.choice([256, 1024, 65536])))
        )
        out = inflate_device_v2(
            np.frombuffer(body, np.uint8), size_hint=n + 1024,
            stride_bits=1 << 13, max_cursors=256,
        )
        assert out is None or bytes(out) == src, trial
        assert out is not None, ("declined healthy v3 stream", trial)


def test_roundtrip_zlib_stream(paradiselost):
    for lvl in (1, 6, 9):
        zc = zlib.compress(paradiselost, lvl)
        out = inflate_device_v2(
            _raw(zc[2:-4]), stride_bits=1 << 14, max_cursors=256
        )
        assert out is not None and bytes(out) == paradiselost, lvl


def test_single_and_fixed_blocks():
    small = zlib.compress(b"hello hello hello world", 6)
    out = inflate_device_v2(_raw(small[2:-4]))
    assert bytes(out) == b"hello hello hello world"
    fx = zlib.compressobj(1, zlib.DEFLATED, -15)
    data = fx.compress(b"abcd" * 64) + fx.flush()
    out = inflate_device_v2(_raw(data))
    assert bytes(out) == b"abcd" * 64


def test_incompressible_decodes_on_device():
    """Stored blocks decode via the transparent byte LUT —
    no host fallback (reference inline path: infblocks.ts:243-333)."""
    rng = np.random.default_rng(0)
    blob = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    zc = zlib.compress(blob, 6)  # stored blocks
    out = inflate_device_v2(_raw(zc[2:-4]))
    assert out is not None and bytes(out) == blob


def test_mixed_stored_and_huffman_decodes_on_device(paradiselost):
    """Stored runs hidden behind Huffman blocks (invisible to
    discovery) splice in via the early-EOB host gap walk."""
    rng = np.random.default_rng(5)
    src = (
        paradiselost[:150000]
        + rng.integers(0, 256, 120000, dtype=np.uint8).tobytes()
        + b"\x00" * 50000
        + paradiselost[:100000]
    )
    zc = zlib.compress(src, 6)
    out = inflate_device_v2(_raw(zc[2:-4]), size_hint=len(src) + 1024)
    assert out is not None and bytes(out) == src


def test_dictionary(paradiselost):
    dictionary = paradiselost[:4096]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=dictionary)
    data = c.compress(paradiselost[4096 : 1 << 17]) + c.flush()
    out = inflate_device_v2(
        _raw(data), dictionary=np.frombuffer(dictionary, np.uint8),
        stride_bits=1 << 14, max_cursors=128,
    )
    if out is not None:
        assert bytes(out) == paradiselost[4096 : 1 << 17]


def test_fuzz_vs_zlib():
    rng = np.random.default_rng(7)
    base = corpus.artifact("paradiselost.txt")
    for trial in range(6):
        n = int(rng.integers(2000, 1 << 17))
        off = int(rng.integers(0, len(base) - n))
        blob = base[off : off + n]
        zc = zlib.compress(blob, int(rng.integers(1, 10)))
        out = inflate_device_v2(
            _raw(zc[2:-4]), stride_bits=1 << 13, max_cursors=128
        )
        if out is not None:
            assert bytes(out) == blob, trial


@pytest.mark.parametrize("ndev", [3, 8])
def test_sharded_inflate_mesh(paradiselost, ndev):
    """Multi-device inflate: cursor tokenize sharded over a CPU mesh."""
    from tpuzlib.parallel import make_mesh, sharded_inflate

    wire = bytes(tpuzlib.deflate(paradiselost, level=6))
    mesh = make_mesh(ndev, platform="cpu")
    out = sharded_inflate(
        _raw(wire[2:-4]), mesh, stride_bits=1 << 14, max_cursors=256
    )
    assert out is not None and bytes(out) == paradiselost
