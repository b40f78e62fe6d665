"""Device-kernel tests (run on the CPU jax backend; same jit code paths
as the GPU) and mesh-sharded pipeline tests on 8 virtual devices."""

import pathlib
import sys
import zlib

import numpy as np
import pytest

from tpuzlib import corpus

TEXT = (b"the quick brown fox jumps over the lazy dog. " * 4000)[:131072]


@pytest.fixture(scope="module")
def mixed_data(rng=None):
    r = np.random.default_rng(3)
    parts = [
        TEXT[:50000],
        r.integers(0, 256, 30000, dtype=np.uint8).tobytes(),
        b"\x00" * 20000,
        TEXT[:31072],
    ]
    return b"".join(parts)


def test_segment_parse_xla_roundtrip(mixed_data):
    """The retained v3 support pieces in kernels/deflate_device: the XLA
    segment parse agrees with a host walk of the same step tape."""
    import jax
    import jax.numpy as jnp

    from tpuzlib.kernels import deflate_device as dd

    rng = np.random.default_rng(2)
    n = 1 << 14
    step = np.ones(n, np.int32)
    i = 0
    want = np.zeros(n, bool)
    while i < n:
        want[i] = True
        s = int(rng.integers(1, 9))
        s = min(s, dd.SEG - (i % dd.SEG))
        step[i] = s
        i += s
    got = np.asarray(
        jax.jit(lambda st: dd.segment_parse_xla(jax, jnp, st, n))(
            jnp.asarray(step)
        )
    )
    assert (got == want).all()


def test_device_deflate_v3_roundtrip_small_chunks(mixed_data):
    from tpuzlib.kernels.deflate_device3 import deflate_device_v3

    raw = deflate_device_v3(
        np.frombuffer(mixed_data, np.uint8), level=4, chunk=1 << 16, batch=2
    )
    assert zlib.decompress(bytes(raw), -15) == mixed_data


def test_device_inflate_roundtrip(mixed_data):
    from tpuzlib.kernels.inflate_device2 import inflate_device_v2

    wire = zlib.compress(mixed_data, 6)[2:-4]
    out = inflate_device_v2(np.frombuffer(wire, np.uint8))
    assert out is not None and bytes(out) == mixed_data


def test_device_inflate_ultracompressible_fallback():
    """Ultra-compressible data (~2 bits/token) overflows the per-cursor
    token tape; the device path must signal fallback (None) — never
    corrupt — and the public API must still decode via the host engine
    (the documented token-cap-overflow contract)."""
    import tpuzlib
    from tpuzlib.kernels.inflate_device2 import inflate_device_v2

    data = b"\x00" * 3_000_000
    wire = zlib.compress(data, 9)
    out = inflate_device_v2(np.frombuffer(wire[2:-4], np.uint8))
    assert out is None or bytes(out) == data
    assert bytes(tpuzlib.inflate(wire)) == data


def test_device_inflate_decodes_device_deflate(mixed_data):
    from tpuzlib.kernels.deflate_device3 import deflate_device_v3
    from tpuzlib.kernels.inflate_device2 import inflate_device_v2

    raw = deflate_device_v3(np.frombuffer(mixed_data, np.uint8), level=6,
                            chunk=1 << 16, batch=2)
    out = inflate_device_v2(np.frombuffer(bytes(raw), np.uint8))
    assert out is not None and bytes(out) == mixed_data


def test_device_dictionary_context():
    """Chunk halos: matches must reach across chunk boundaries."""
    from tpuzlib.kernels.deflate_device3 import deflate_device_v3

    data = TEXT[:100000]
    raw_chunked = deflate_device_v3(np.frombuffer(data, np.uint8), level=6,
                                    chunk=1 << 15, batch=2)
    assert zlib.decompress(bytes(raw_chunked), -15) == data


# --- sharded pipeline -------------------------------------------------------


def test_sharded_deflate_8dev():
    import jax

    from tpuzlib.parallel import make_mesh, sharded_deflate

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh()
    data = np.frombuffer(TEXT[: 8 * 16384], np.uint8)
    out, adler, crc = sharded_deflate(data, mesh, level=6)
    assert zlib.decompress(bytes(out)) == data.tobytes()
    assert adler == zlib.adler32(data.tobytes())
    assert crc == zlib.crc32(data.tobytes())


def test_sharded_checksum_combine_random():
    import jax

    from tpuzlib.parallel import make_mesh, sharded_deflate

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = make_mesh(4)
    r = np.random.default_rng(11)
    data = r.integers(0, 256, 4 * 4096, dtype=np.uint8)
    out, adler, crc = sharded_deflate(data, mesh, level=1)
    assert adler == zlib.adler32(data.tobytes())
    assert crc == zlib.crc32(data.tobytes())
    assert zlib.decompress(bytes(out)) == data.tobytes()


def test_graft_entry():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import importlib

    import __graft_entry__ as g

    importlib.reload(g)
    import jax

    fn, args = g.entry()
    words, nbits, ok = jax.jit(fn)(*args)
    assert np.asarray(ok).all() and (np.asarray(nbits) > 0).all()
    g.dryrun_multichip(min(8, len(jax.devices("cpu"))), "cpu")


def test_fully_jit_dynamic_encoder():
    """v3 batched encoder: trees + header + body entirely on device;
    output must be a valid dynamic DEFLATE stream for text, random and
    constant payloads (stored fallback allowed via ok flag)."""
    from tpuzlib.kernels.deflate_device3 import deflate_device_v3

    n = 1 << 15
    for payload in (
        TEXT[:n],
        np.random.default_rng(5).integers(0, 256, n, np.uint8).tobytes(),
        b"\x00" * n,
    ):
        raw = deflate_device_v3(
            np.frombuffer(payload, np.uint8), level=6, chunk=n, batch=1
        )
        assert zlib.decompress(bytes(raw), -15) == payload


def test_device_package_merge_matches_host(rng):
    """Device package-merge lengths must satisfy Kraft and match the host
    optimum's total cost."""
    import jax
    import jax.numpy as jnp

    from tpuzlib.codec.huffman_encode import package_merge
    from tpuzlib.kernels.huffman_device import package_merge_device

    for trial in range(6):
        freqs = rng.integers(0, 1000, 286, np.int64)
        freqs[rng.integers(0, 286, 100)] = 0
        dev = np.asarray(
            package_merge_device(jax, jnp, jnp.asarray(freqs.astype(np.int32)), 15)
        )
        host = package_merge(freqs, 15)
        kraft = (1 << 15) * np.sum(np.where(dev > 0, 2.0 ** (-dev.astype(float)), 0))
        assert kraft <= (1 << 15) + 1e-6
        cost_dev = int((freqs * dev).sum())
        cost_host = int((freqs * host).sum())
        assert cost_dev == cost_host, (trial, cost_dev, cost_host)


def test_device_fully_jit_stream(mixed_data):
    """Multi-chunk stream from the zero-host-sync v3 encoder must decode
    externally."""
    from tpuzlib.kernels.deflate_device3 import deflate_device_v3

    raw = deflate_device_v3(
        np.frombuffer(mixed_data[:100000], np.uint8), level=4, chunk=1 << 15,
        batch=2,
    )
    assert zlib.decompress(bytes(raw), -15) == mixed_data[:100000]


@pytest.mark.parametrize("ndev", [3, 5, 7])
def test_sharded_deflate_odd_device_counts(ndev):
    import jax

    from tpuzlib.parallel import make_mesh, sharded_deflate

    if len(jax.devices()) < ndev:
        pytest.skip("needs %d virtual devices" % ndev)
    mesh = make_mesh(ndev)
    data = np.frombuffer(TEXT[: ndev * 8192], np.uint8)
    out, adler, crc = sharded_deflate(data, mesh, level=4)
    assert zlib.decompress(bytes(out)) == data.tobytes()
    assert adler == zlib.adler32(data.tobytes())
    assert crc == zlib.crc32(data.tobytes())


def test_sharded_deflate_arbitrary_lengths():
    """v2 sharded path: any input length; padding never reaches output
    and checksums cover exactly the valid bytes."""
    import zlib

    from tpuzlib.parallel import make_mesh, sharded_deflate

    mesh = make_mesh(8, platform="cpu")
    rng = np.random.default_rng(5)
    base = rng.integers(0, 40, 1 << 16, dtype=np.uint8)
    for n in (50000, 12345, 63, 8 * 4096 - 1, 40000):
        data = np.ascontiguousarray(base[:n])
        out, adler, crc = sharded_deflate(data, mesh, level=6)
        dec = zlib.decompress(bytes(out))
        assert dec == data.tobytes()
        assert adler == zlib.adler32(data.tobytes())
        assert crc == zlib.crc32(data.tobytes())


def test_sharded_deflate_v3_ratio():
    """The mesh path now runs the flagship v3 encoder per shard: on text
    it must land near the single-device v3 ratio (~0.4), far below the
    static-tree ~0.58 the retired v1 mesh path produced."""
    from tpuzlib.parallel import make_mesh, sharded_deflate

    mesh = make_mesh(4, platform="cpu")
    text = np.frombuffer(
        corpus.artifact("paradiselost.txt")[: 1 << 16],
        np.uint8,
    )
    out, _, _ = sharded_deflate(text, mesh, level=6)
    import zlib

    assert zlib.decompress(bytes(out)) == text.tobytes()
    assert len(out) < 0.5 * len(text)
