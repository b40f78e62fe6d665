"""Speculative parallel inflate (rapidgzip-style) for arbitrary streams."""

import zlib

import numpy as np
import pytest

from tpuzlib import corpus
from tpuzlib.parallel.speculative import find_block_start, inflate_parallel


def test_discovery_finds_true_boundary(paradiselost):
    wire = np.frombuffer(zlib.compress(paradiselost, 6)[2:-4], np.uint8)
    pos = find_block_start(wire, len(wire) // 2)
    assert pos is not None
    # decoding from the discovered position must succeed for a long run
    from tpuzlib.parallel.speculative import _tokenize_range

    litlen, dist, end_bit, fin = _tokenize_range(
        wire, None, pos, len(wire) * 8, len(wire) * 8
    )
    assert fin and len(litlen) > 1000


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("segments", [1, 2, 3, 5])
def test_parallel_inflate_levels(level, segments, paradiselost):
    data = (paradiselost * 3)[: 1 << 20]
    wire = zlib.compress(data, level)[2:-4]
    out = inflate_parallel(wire, n_segments=segments)
    assert bytes(out) == data


def test_parallel_inflate_stored_blocks(rng):
    """Random data -> stored blocks: discovery finds no dynamic headers
    and the decode falls back to sequential, still correct."""
    data = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    wire = zlib.compress(data, 6)[2:-4]
    out = inflate_parallel(wire, n_segments=4)
    assert bytes(out) == data


def test_parallel_inflate_mixed_content(rng, paradiselost):
    data = paradiselost + rng.integers(0, 256, 1 << 19, np.uint8).tobytes() + paradiselost
    wire = zlib.compress(data, 9)[2:-4]
    out = inflate_parallel(wire, n_segments=4)
    assert bytes(out) == data


def test_parallel_inflate_with_dictionary(paradiselost):
    D = paradiselost[:4000]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8, 0, D)
    wire = c.compress(paradiselost[:200000]) + c.flush()
    out = inflate_parallel(wire, n_segments=2, dictionary=np.frombuffer(D, np.uint8))
    assert bytes(out) == paradiselost[:200000]


def test_parallel_inflate_own_output(paradiselost):
    """Our own parallel-deflate streams (with sync-flush boundaries)
    decode through the speculative path too."""
    import tpuzlib

    data = (paradiselost * 8)[: 3 << 20]
    wire = bytes(tpuzlib.deflate(data, format="raw", level=6))
    out = inflate_parallel(wire, n_segments=3)
    assert bytes(out) == data


def test_container_aware_parallel(paradiselost):
    import tpuzlib
    from tpuzlib.parallel import inflate_parallel_container

    data = (paradiselost * 2)[: 1 << 20]
    for fmt in ("deflate", "gzip", "raw"):
        wire = tpuzlib.deflate(data, format=fmt, level=6)
        out = inflate_parallel_container(wire, n_segments=3)
        assert bytes(out) == data
    # corrupted trailer must fail verification
    wire = bytearray(tpuzlib.deflate(data, format="gzip"))
    wire[-2] ^= 0xFF
    with pytest.raises(ValueError, match="integrity"):
        inflate_parallel_container(bytes(wire), n_segments=2)


def test_find_all_block_starts_native_vs_numpy(monkeypatch):
    """The one-pass header scan (round 4) must find exactly the real
    block headers, and the numpy fallback must agree with the native
    tz_find_headers scan."""
    import zlib

    import numpy as np

    from tpuzlib.parallel import speculative as sp

    text = corpus.artifact("paradiselost.txt")[: 1 << 18]
    wire = zlib.compress(text, 6)
    buf = np.frombuffer(wire[2:-4], np.uint8)

    native = sp.find_all_block_starts(buf)
    import tpuzlib.native.bindings as nb

    monkeypatch.setattr(nb, "native_available", lambda: False)
    fallback = sp.find_all_block_starts(buf)
    assert list(native) == list(fallback)
    # the stream's actual headers: first block at bit 0 is not a
    # *discovered* candidate requirement, but subsequent ones must chain
    from tpuzlib.kernels.inflate_device2 import _plan_blocks

    plan = _plan_blocks(buf)
    real = [p[0] for p in plan]
    for h in real[1:]:
        assert h in native, h
