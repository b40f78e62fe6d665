"""Inflate tests: corpus decode matrix (reference test/index.html),
streaming split-stream decode, preset dictionaries, error semantics.
Oracle: stdlib-made corpus artifacts (tpuzlib.corpus) + Python zlib."""

import zlib

import numpy as np
import pytest

import tpuzlib
from tpuzlib import corpus
from tpuzlib import Inflater, inflate
from tpuzlib.api.inflate_api import InflaterOptions


def read(name):
    return corpus.artifact(name)


# --- container decode matrix (reference test/index.html:55-137) ------------


@pytest.mark.parametrize(
    "artifact,original",
    [
        ("simple.deflate", "simple.txt"),
        ("simple.gz", "simple.txt"),
        ("paradiselost.deflate", "paradiselost.txt"),
        ("paradiselost.gz", "paradiselost.txt"),
    ],
)
def test_inflate_corpus(artifact, original):
    out = inflate(read(artifact))
    assert bytes(out) == read(original)


def test_inflate_raw():
    out = inflate(read("simple.raw"))
    assert bytes(out) == read("simple.txt")


def test_inflate_binary_vertices():
    data = read("vertices.deflate")
    out = inflate(data)
    assert bytes(out) == zlib.decompress(data)
    assert tpuzlib.adler32(out) == zlib.adler32(zlib.decompress(data))


# --- streaming (reference test/index.html:29-53 testInflateParts) ----------


def test_inflate_parts():
    inflater = Inflater()
    buffers = []
    buffers += inflater.append(read("paradiselost.part1.deflate"))
    buffers += inflater.append(read("paradiselost.part2.deflate"))
    result = inflater.finish()
    assert result.success and result.complete
    assert result.checksum == "match"
    assert bytes(tpuzlib.mergeBuffers(buffers)) == read("paradiselost.txt")


@pytest.mark.parametrize("chunk_size", [1, 2, 3, 7, 100, 1000, 65536])
def test_inflate_byte_granular_streaming(chunk_size):
    """Suspend/resume at arbitrary byte boundaries (reference
    infblocks.ts:164-179 suspend/resume contract)."""
    data = read("simple.gz") if chunk_size < 50 else read("paradiselost.deflate")
    want = read("simple.txt") if chunk_size < 50 else read("paradiselost.txt")
    inflater = Inflater()
    buffers = []
    for i in range(0, len(data), chunk_size):
        buffers += inflater.append(data[i : i + chunk_size])
    result = inflater.finish()
    assert result.success
    assert bytes(tpuzlib.mergeBuffers(buffers)) == want


def test_inflate_result_metadata_gzip():
    inflater = Inflater()
    buffers = inflater.append(read("paradiselost.gz"))
    r = inflater.finish()
    assert r.success and r.complete
    assert r.checksum == "match" and r.fileSize == "match"
    assert r.fileName == "paradiselost.txt"
    assert r.modDate is not None


def test_inflate_result_metadata_zlib():
    inflater = Inflater()
    inflater.append(read("simple.deflate"))
    r = inflater.finish()
    assert r.success and r.checksum == "match"
    assert r.fileSize == "unchecked"
    assert r.fileName == ""
    assert r.modDate is None


def test_truncated_input_not_an_error():
    """Reference README.md:78-81: truncated input reports complete=False,
    does not throw."""
    data = read("paradiselost.deflate")
    inflater = Inflater()
    buffers = inflater.append(data[: len(data) // 2])
    r = inflater.finish()
    assert not r.success and not r.complete
    # prefix of output must still be correct
    got = bytes(tpuzlib.mergeBuffers(buffers))
    assert got == read("paradiselost.txt")[: len(got)] and len(got) > 0


# --- preset dictionary (reference test/index.html:173-208) ------------------

DICT = (b"the and of to in that he his with was for on is at by not this "
        b"from But are they which or an him")


def test_dictionary_roundtrip_zlib_oracle():
    data = b"he was with his and that him not at this they are the best of all"
    comp = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY, DICT)
    wire = comp.compress(data) + comp.flush()
    out = inflate(wire, dictionary=DICT)
    assert bytes(out) == data


def test_dictionary_required():
    comp = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY, DICT)
    wire = comp.compress(b"he was with his") + comp.flush()
    with pytest.raises(ValueError, match="dictionary required"):
        inflate(wire)


def test_dictionary_wrong():
    comp = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY, DICT)
    wire = comp.compress(b"he was with his") + comp.flush()
    with pytest.raises(ValueError, match="not valid"):
        inflate(wire, dictionary=b"a completely different dictionary")


def test_dictionary_streaming():
    data = (DICT + b" some new words appear here too ") * 50
    comp = zlib.compressobj(9, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY, DICT)
    wire = comp.compress(data) + comp.flush()
    inflater = Inflater(InflaterOptions(dictionary=DICT))
    buffers = []
    for i in range(0, len(wire), 37):
        buffers += inflater.append(wire[i : i + 37])
    r = inflater.finish()
    assert r.success and r.checksum == "match"
    assert bytes(tpuzlib.mergeBuffers(buffers)) == data


# --- option / input validation (sd-inflate.ts:60-80) ------------------------


def test_option_validation():
    with pytest.raises(TypeError, match="raw"):
        Inflater(InflaterOptions(raw="yes"))
    with pytest.raises(ValueError, match="raw is true"):
        Inflater(InflaterOptions(raw=True, dictionary=b"abc"))
    with pytest.raises(TypeError, match="buffer"):
        Inflater(InflaterOptions(dictionary=123))
    with pytest.raises(TypeError, match="buffer"):
        Inflater().append(3.14)
    with pytest.raises(ValueError, match="too small"):
        inflate(b"x")


def test_no_reuse():
    inf = Inflater()
    inf.append(read("simple.deflate"))
    inf.finish()
    with pytest.raises(RuntimeError):
        inf.append(b"anything")


# --- malformed data ---------------------------------------------------------


def test_bad_zlib_header():
    with pytest.raises(ValueError, match="header check"):
        Inflater().append(b"\x78\x00" + b"\x00" * 10)


def test_bad_method():
    with pytest.raises(ValueError, match="compression method"):
        Inflater().append(b"\x77\x01" + b"\x00" * 10)


def test_invalid_block_type():
    # raw stream: BTYPE=3
    with pytest.raises(ValueError, match="invalid block type"):
        Inflater(InflaterOptions(raw=True)).append(b"\x07\x00\x00")


def test_invalid_stored_lengths():
    # BTYPE=0 but NLEN != ~LEN
    bad = b"\x01\x05\x00\x00\x00"
    with pytest.raises(ValueError, match="stored block length"):
        Inflater(InflaterOptions(raw=True)).append(bad + b"\x00" * 8)


def test_corrupted_checksum_mismatch():
    data = bytearray(read("simple.deflate"))
    data[-1] ^= 0xFF  # corrupt adler trailer
    inflater = Inflater()
    inflater.append(bytes(data))
    r = inflater.finish()
    assert r.complete and r.checksum == "mismatch" and not r.success
    with pytest.raises(ValueError, match="integrity"):
        inflate(bytes(data))


def test_random_zlib_streams_roundtrip(rng):
    """Fuzz vs zlib across levels/sizes incl. stored and rle-ish data."""
    for trial in range(12):
        n = int(rng.integers(0, 50000))
        kind = trial % 3
        if kind == 0:
            raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # random
        elif kind == 1:
            raw = (b"abcab" * (n // 5 + 1))[:n]  # repetitive
        else:
            raw = rng.integers(97, 105, n, dtype=np.uint8).tobytes()  # texty
        level = int(rng.integers(1, 10))
        wire = zlib.compress(raw, level)
        assert bytes(inflate(wire)) == raw, (trial, n, level)


def test_gzip_all_header_fields():
    """gzip with FEXTRA, FNAME, FCOMMENT, FHCRC set."""
    import struct

    payload = zlib.compress(b"hello world hello world", 6)[2:-4]
    hdr = struct.pack("<BBBBIBB", 0x1F, 0x8B, 8, 0x02 | 0x04 | 0x08 | 0x10,
                      1234567, 0, 3)
    hdr += struct.pack("<H", 4) + b"EXTR"
    hdr += b"name.txt\0"
    hdr += b"a comment\0"
    hdr += struct.pack("<H", zlib.crc32(hdr) & 0xFFFF)
    wire = hdr + payload + struct.pack("<II", zlib.crc32(b"hello world hello world"),
                                       23)
    inflater = Inflater()
    bufs = inflater.append(wire)
    r = inflater.finish()
    assert r.success and r.fileName == "name.txt"
    assert bytes(tpuzlib.mergeBuffers(bufs)) == b"hello world hello world"
