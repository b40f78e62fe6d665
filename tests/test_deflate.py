"""Deflate tests: round-trips (self + zlib cross-oracle), size parity
with stdlib zlib at every level on the seeded corpora (tpuzlib.corpus),
containers, dictionaries, streaming."""

import gzip as gzip_mod
import zlib

import numpy as np
import pytest

import tpuzlib
from tpuzlib import corpus
from tpuzlib import Deflater, deflate, inflate
from tpuzlib.api.deflate_api import DeflaterOptions


def read(name):
    return corpus.artifact(name)


@pytest.fixture(scope="module")
def vertices():
    return zlib.decompress(read("vertices.deflate"))


# --- size parity: ours must be <= reference (== zlib) at the same level ----


@pytest.mark.parametrize("level", range(1, 10))
def test_size_parity_paradiselost(level, paradiselost):
    ours = deflate(paradiselost, level=level)
    assert zlib.decompress(bytes(ours)) == paradiselost
    assert len(ours) <= len(zlib.compress(paradiselost, level))


@pytest.mark.parametrize("level", [1, 4, 6, 9])
def test_size_parity_vertices(level, vertices):
    ours = deflate(vertices, level=level)
    assert zlib.decompress(bytes(ours)) == vertices
    assert len(ours) <= len(zlib.compress(vertices, level))


def test_size_parity_corpus_artifacts(paradiselost):
    """Size parity with the stdlib-made corpus artifacts at level 6."""
    assert len(deflate(paradiselost, level=6)) <= len(read("paradiselost.deflate"))
    assert len(deflate(read("simple.txt"), level=6)) <= len(read("simple.deflate"))
    gz = deflate(read("simple.txt"), format="gzip", fileName="simple.txt")
    assert len(gz) <= len(read("simple.gz"))


# --- round-trips through our own inflater and external oracles -------------


@pytest.mark.parametrize("level", [1, 6, 9])
def test_roundtrip_own_inflater(level, paradiselost):
    wire = deflate(paradiselost, level=level)
    assert bytes(inflate(wire)) == paradiselost


def test_roundtrip_gzip_container():
    data = read("paradiselost.txt")
    wire = deflate(data, format="gzip", fileName="paradiselost.txt")
    # external oracle
    assert gzip_mod.decompress(bytes(wire)) == data
    # our inflater reads back metadata
    inf = tpuzlib.Inflater()
    bufs = inf.append(wire)
    r = inf.finish()
    assert r.success and r.fileName == "paradiselost.txt"
    assert r.checksum == "match" and r.fileSize == "match"
    assert bytes(tpuzlib.mergeBuffers(bufs)) == data


def test_roundtrip_raw_container():
    data = b"raw container round trip" * 100
    wire = deflate(data, format="raw")
    assert zlib.decompress(bytes(wire), -15) == data
    assert bytes(inflate(wire)) == data


@pytest.mark.parametrize(
    "payload",
    [b"", b"a", b"ab", b"abc", b"\x00" * 10, bytes(range(256)), b"x" * 65535,
     b"x" * 65536, b"x" * 200000],
)
def test_edge_payloads(payload):
    for level in (1, 6, 9):
        wire = deflate(payload, level=level)
        assert zlib.decompress(bytes(wire)) == payload


def test_incompressible_uses_stored(rng):
    data = rng.integers(0, 256, 100000, dtype=np.uint8).tobytes()
    wire = deflate(data, level=6)
    assert zlib.decompress(bytes(wire)) == data
    assert len(wire) <= len(zlib.compress(data, 6))


def test_fuzz_roundtrip(rng):
    for trial in range(10):
        n = int(rng.integers(0, 120000))
        kind = trial % 3
        if kind == 0:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif kind == 1:
            data = (b"the quick brown fox " * (n // 20 + 1))[:n]
        else:
            data = rng.integers(0, 4, n, dtype=np.uint8).tobytes()
        level = int(rng.integers(1, 10))
        wire = deflate(data, level=level)
        assert zlib.decompress(bytes(wire)) == data, (trial, n, level)
        assert bytes(inflate(wire)) == data, (trial, n, level)


# --- preset dictionary (sd-deflate.ts:80-90, deflate.ts:1184-1216) ---------

DICT = (b"the and of to in that he his with was for on is at by not this "
        b"from But are they which or an him")


def test_dictionary_roundtrip():
    data = b"he was with his and that him not at this the and of to in"
    wire = deflate(data, dictionary=DICT)
    d = zlib.decompressobj(zdict=DICT)
    assert d.decompress(bytes(wire)) == data
    assert bytes(inflate(wire, dictionary=DICT)) == data
    # dictionary should help
    assert len(wire) < len(deflate(data))


def test_dictionary_reference_style(paradiselost):
    """Reference test/index.html:173-208: 409-byte dictionary of frequent
    words, full corpus round-trip."""
    words = {}
    for w in paradiselost.split():
        words[w] = words.get(w, 0) + 1
    top = sorted(words, key=words.get, reverse=True)[:80]
    dictionary = b" ".join(top)[:409]
    data = paradiselost[:100000]
    wire = deflate(data, dictionary=dictionary, level=6)
    assert bytes(inflate(wire, dictionary=dictionary)) == data


# --- streaming -------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 999, 60000, 1 << 20])
def test_streaming_deflater(chunk, paradiselost):
    d = Deflater(level=6)
    bufs = []
    for i in range(0, len(paradiselost), chunk):
        bufs += d.append(paradiselost[i : i + chunk])
    bufs += d.finish()
    wire = bytes(tpuzlib.mergeBuffers(bufs))
    assert zlib.decompress(wire) == paradiselost


def test_streaming_emits_incrementally():
    """Large appends must produce output before finish()."""
    d = Deflater(level=1)
    data = np.zeros(4 << 20, dtype=np.uint8).tobytes()
    bufs = d.append(data)
    assert sum(len(b) for b in bufs) > 0
    bufs += d.finish()
    assert zlib.decompress(bytes(tpuzlib.mergeBuffers(bufs))) == data


# --- option validation (sd-deflate.ts:60-96) --------------------------------


def test_option_validation():
    with pytest.raises(ValueError, match="between 1 and 9"):
        Deflater(DeflaterOptions(level=0))
    with pytest.raises(ValueError, match="between 1 and 9"):
        Deflater(DeflaterOptions(level=10))
    with pytest.raises(ValueError, match="container"):
        Deflater(DeflaterOptions(format="zip"))
    with pytest.raises(TypeError, match="fileName"):
        Deflater(DeflaterOptions(fileName=42))
    with pytest.raises(TypeError, match="dictionary"):
        Deflater(DeflaterOptions(format="gzip", dictionary=b"abc"))
    with pytest.raises(RuntimeError, match="finish before"):
        Deflater().finish()
    with pytest.raises(TypeError, match="buffer"):
        Deflater().append(42)


def test_no_reuse():
    d = Deflater()
    d.append(b"data")
    d.finish()
    with pytest.raises(RuntimeError):
        d.append(b"more")
