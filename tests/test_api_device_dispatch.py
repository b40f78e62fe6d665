"""Public one-shot APIs dispatch to the device kernels.

TPUZLIB_DEVICE=1 forces the dispatch on the CPU test backend (the same
jit code paths as on the GPU); the trace counters prove which path ran —
a regression to 100% host fallback fails here.
Reference entries: sd-inflate.ts:189, sd-deflate.ts:263.
"""

import zlib

import numpy as np
import pytest

import tpuzlib
from tpuzlib import corpus
from tpuzlib.utils import trace

TEXT = corpus.artifact("paradiselost.txt")


@pytest.fixture(autouse=True)
def _counters():
    trace.reset_counters()
    yield


def test_oneshot_deflate_device_dispatch(monkeypatch):
    monkeypatch.setenv("TPUZLIB_DEVICE", "1")
    src = (TEXT * 3)[: 1 << 20 + 1]
    wire = bytes(tpuzlib.deflate(src, level=6))
    assert zlib.decompress(wire) == src
    c = trace.get_counters()
    assert c.get("deflate.device", 0) >= len(src)
    assert c.get("deflate.device_fallback", 0) == 0


def test_oneshot_deflate_device_disabled(monkeypatch):
    monkeypatch.setenv("TPUZLIB_DEVICE", "0")
    src = (TEXT * 3)[: 1 << 20]
    wire = bytes(tpuzlib.deflate(src, level=6))
    assert zlib.decompress(wire) == src
    assert trace.get_counters().get("deflate.device", 0) == 0


def test_oneshot_inflate_device_dispatch(monkeypatch):
    monkeypatch.setenv("TPUZLIB_DEVICE", "0")  # host-compress first
    src = (TEXT * 2)[: 1 << 20]
    wire = bytes(tpuzlib.deflate(src, level=6))
    assert len(wire) >= (1 << 18)
    monkeypatch.setenv("TPUZLIB_DEVICE", "1")
    out = tpuzlib.inflate(wire)
    assert bytes(out) == src
    c = trace.get_counters()
    assert c.get("inflate.device", 0) >= len(src)


def test_oneshot_inflate_device_checksum_verdict(monkeypatch):
    monkeypatch.setenv("TPUZLIB_DEVICE", "0")
    src = (TEXT * 2)[: 1 << 20]
    wire = bytearray(tpuzlib.deflate(src, level=6))
    wire[-1] ^= 0xFF  # corrupt the adler trailer
    monkeypatch.setenv("TPUZLIB_DEVICE", "1")
    with pytest.raises(ValueError, match="Data integrity check failed"):
        tpuzlib.inflate(bytes(wire))


def test_oneshot_gzip_device_roundtrip(monkeypatch):
    monkeypatch.setenv("TPUZLIB_DEVICE", "1")
    src = (TEXT * 3)[: (1 << 20) + 12345]
    wire = bytes(tpuzlib.deflate(src, format="gzip", level=6))
    import gzip

    assert gzip.decompress(wire) == src
    out = tpuzlib.inflate(wire)
    assert bytes(out) == src
