"""The five measurement configurations of BASELINE.md as explicit tests."""

import zlib

import numpy as np
import pytest

import tpuzlib
from tpuzlib import corpus


def read(name):
    return corpus.artifact(name)


def test_config1_inflate_corpus():
    """inflate test/simple.deflate + test/paradiselost.gz, verify bytes."""
    assert bytes(tpuzlib.inflate(read("simple.deflate"))) == read("simple.txt")
    assert bytes(tpuzlib.inflate(read("paradiselost.gz"))) == read("paradiselost.txt")


def test_config2_raw_level1_roundtrip():
    """raw deflate level 1 on paradiselost.txt round-trip."""
    data = read("paradiselost.txt")
    wire = tpuzlib.deflate(data, format="raw", level=1)
    assert bytes(tpuzlib.inflate(wire)) == data
    assert zlib.decompress(bytes(wire), -15) == data


@pytest.mark.parametrize("level", [6, 9])
def test_config3_dynamic_zlib_vertices(level):
    """deflate level 6/9 dynamic-Huffman zlib container with adler check
    on the vertices corpus."""
    data = zlib.decompress(read("vertices.deflate"))
    wire = tpuzlib.deflate(data, format="deflate", level=level)
    inf = tpuzlib.Inflater()
    bufs = inf.append(wire)
    r = inf.finish()
    assert r.success and r.checksum == "match"
    assert bytes(tpuzlib.mergeBuffers(bufs)) == data
    assert len(wire) <= len(zlib.compress(data, level))


def test_config4_streaming_parts_with_dictionary():
    """streaming chunked Inflater/Deflater (split streams) with preset
    dictionary."""
    # a split stream (one zlib stream cut in two)
    inf = tpuzlib.Inflater()
    bufs = inf.append(read("paradiselost.part1.deflate"))
    bufs += inf.append(read("paradiselost.part2.deflate"))
    assert inf.finish().success
    assert bytes(tpuzlib.mergeBuffers(bufs)) == read("paradiselost.txt")
    # dictionary round-trip through chunked Deflater + chunked Inflater
    data = read("paradiselost.txt")[:150000]
    dictionary = data[:4096]
    d = tpuzlib.Deflater(level=6, dictionary=dictionary)
    wire_parts = []
    for i in range(0, len(data), 37000):
        wire_parts += d.append(data[i : i + 37000])
    wire_parts += d.finish()
    wire = bytes(tpuzlib.mergeBuffers(wire_parts))
    inf = tpuzlib.Inflater(dictionary=dictionary)
    bufs = []
    for i in range(0, len(wire), 13000):
        bufs += inf.append(wire[i : i + 13000])
    assert inf.finish().success
    assert bytes(tpuzlib.mergeBuffers(bufs)) == data


def test_config5_member_sharding_crc_combine(rng):
    """concatenated gzip members sharded, crc32 combine + in-order
    gather (host-thread flavor; the mesh flavor is test_device.py)."""
    from tpuzlib.parallel.members import compress_members, decompress_members

    data = (read("paradiselost.txt") * 4)[: 1 << 21]
    wire, idx = compress_members(data, level=6, member_size=1 << 19)
    assert len(idx) == 4
    out, combined_crc = decompress_members(wire, idx)
    assert bytes(out) == data
    assert combined_crc == zlib.crc32(data)
