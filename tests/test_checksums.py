"""Checksum tests: oracle is Python's zlib (same math as reference
src/adler32.ts / src/crc32.ts)."""

import zlib

import numpy as np
import pytest

from tpuzlib.api import checksums
from tpuzlib.kernels import adler32 as adler_k
from tpuzlib.kernels import crc32 as crc_k

LENGTHS = [0, 1, 2, 3, 7, 8, 255, 256, 257, 1000, 4096, 5551, 5552, 5553, 65536, 300001]


def _data(rng, n):
    return rng.integers(0, 256, size=n, dtype=np.uint8)


@pytest.mark.parametrize("n", LENGTHS)
def test_adler32_host(rng, n):
    d = _data(rng, n)
    assert adler_k.adler32_host(d) == zlib.adler32(d.tobytes())


@pytest.mark.parametrize("n", LENGTHS)
def test_crc32_host(rng, n):
    d = _data(rng, n)
    assert crc_k.crc32_host(d) == zlib.crc32(d.tobytes())


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 4096, 100000, 300001])
def test_adler32_device(rng, n):
    d = _data(rng, n)
    assert adler_k.adler32_device(d) == zlib.adler32(d.tobytes())


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 4096, 100000, 300001])
def test_crc32_device(rng, n):
    d = _data(rng, n)
    assert crc_k.crc32_device(d) == zlib.crc32(d.tobytes())


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 0xFFFFFFFF, 12345])
def test_seeds(rng, seed):
    d = _data(rng, 10000)
    b = d.tobytes()
    assert crc_k.crc32_host(d, seed) == zlib.crc32(b, seed)
    assert crc_k.crc32_device(d, seed) == zlib.crc32(b, seed)
    assert adler_k.adler32_host(d, seed) == zlib.adler32(b, seed)
    assert adler_k.adler32_device(d, seed) == zlib.adler32(b, seed)


def test_chaining(rng):
    """Reference README.md:151-161 chaining contract: feed previous result
    as next seed."""
    chunks = [_data(rng, n) for n in [100, 5000, 1, 0, 70000]]
    a, c = 1, 0
    for ch in chunks:
        a = checksums.adler32(ch, a)
        c = checksums.crc32(ch, c)
    whole = b"".join(ch.tobytes() for ch in chunks)
    assert a == zlib.adler32(whole)
    assert c == zlib.crc32(whole)


def test_combine(rng):
    """Associative shard combine — the multi-chip merge primitive."""
    d1, d2 = _data(rng, 33333), _data(rng, 77777)
    whole = d1.tobytes() + d2.tobytes()
    c = crc_k.crc32_combine(
        crc_k.crc32_host(d1), crc_k.crc32_host(d2), len(d2)
    )
    assert c == zlib.crc32(whole)
    a = adler_k.adler32_combine(
        adler_k.adler32_host(d1), adler_k.adler32_host(d2), len(d2)
    )
    assert a == zlib.adler32(whole)


def test_corpus_checksums(paradiselost):
    d = np.frombuffer(paradiselost, dtype=np.uint8)
    assert crc_k.crc32_host(d) == zlib.crc32(paradiselost)
    assert adler_k.adler32_host(d) == zlib.adler32(paradiselost)
    assert crc_k.crc32_device(d) == zlib.crc32(paradiselost)
    assert adler_k.adler32_device(d) == zlib.adler32(paradiselost)


def test_public_api_types(rng):
    d = _data(rng, 1000)
    # accepts bytes, bytearray, memoryview, ndarray of any dtype
    assert checksums.crc32(d.tobytes()) == zlib.crc32(d.tobytes())
    assert checksums.crc32(bytearray(d.tobytes())) == zlib.crc32(d.tobytes())
    assert checksums.crc32(memoryview(d.tobytes())) == zlib.crc32(d.tobytes())
    f32 = rng.random(256, dtype=np.float32)
    assert checksums.crc32(f32) == zlib.crc32(f32.tobytes())
    assert checksums.adler32(f32) == zlib.adler32(f32.tobytes())


@pytest.mark.parametrize("n", [1, 63, 64, 65, 16383, 16384, 16385, 3 * 16384 + 64])
@pytest.mark.parametrize("seed", [0, 77, 0xFFFFFFFF])
def test_crc32_pallas_kernel(rng, n, seed):
    """Fused Triton-route kernel (interpret mode on the CPU) + device
    combine agree with zlib at the edges of a block (64 B) and of a
    program's tile (16 KiB), for several seeds."""
    d = rng.integers(0, 256, n, dtype=np.uint8)
    assert crc_k.crc32_device(d, seed) == zlib.crc32(d.tobytes(), seed)


def test_crc32_kernel_forms_match_plain(rng):
    """Kernel block forms == the plain XLA forms (the reference)."""
    import jax.numpy as jnp

    from tpuzlib.kernels import crc32_pallas

    blocks = jnp.asarray(
        rng.integers(0, 256, (3 * crc32_pallas.TILE, crc32_pallas.BLOCK),
                     dtype=np.uint8)
    )
    assert np.array_equal(
        np.asarray(crc32_pallas.forms(blocks)), np.asarray(crc_k.forms_xla(blocks))
    )


@pytest.mark.parametrize("nb", [1, 2, 3, 5, 8, 13])
def test_crc32_device_combine(rng, nb):
    """Device log-depth combine (front zero-padding to a power of two)
    == the host combine tree."""
    import jax.numpy as jnp

    g = rng.integers(0, 1 << 32, nb, dtype=np.uint32)
    for block in (64, 1024):
        dev = int(crc_k.combine_device(jnp.asarray(g), block))
        assert dev == crc_k._combine_blocks(g, block)


@pytest.mark.parametrize("backend,interpret", [("cpu", True), ("gpu", False)])
def test_crc32_kernel_route(monkeypatch, backend, interpret):
    """The kernel compiles through Triton on the GPU and is interpreted
    only on the CPU."""
    import jax

    from tpuzlib.kernels import crc32_pallas

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert crc32_pallas._interpret() is interpret


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_crc32_kernel_rejects_other_backends(monkeypatch, backend):
    import jax

    from tpuzlib.kernels import crc32_pallas

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(NotImplementedError):
        crc32_pallas._interpret()


def test_adler32_pallas_kernel(rng):
    """Device Adler-32 (plain XLA block sums + modular combine) agrees
    with zlib across block-boundary sizes and seeds."""
    B = adler_k.DEVICE_BLOCK
    for n in (B, 2 * B + 12345, 100, B + 1, 256 * B):
        d = rng.integers(0, 256, n, dtype=np.uint8)
        assert adler_k.adler32_device(d) == zlib.adler32(d.tobytes())
        seed = zlib.adler32(b"prefix bytes")
        assert adler_k.adler32_device(d, seed=seed) == zlib.adler32(
            d.tobytes(), seed
        )


def test_checksum_device_jit_scalars(rng):
    """The traceable device forms inside jit return device scalars that
    finish to zlib's values: crc32's linear form L(data) and adler32's
    (S, W) block sums."""
    import jax
    import jax.numpy as jnp

    for n in (300_000, 1 << 19):
        d = rng.integers(0, 256, n, dtype=np.uint8)
        dd = jnp.asarray(d)
        l_data = jax.jit(crc_k.linear_form_device)(dd)
        assert isinstance(l_data, jax.Array) and l_data.shape == ()
        assert crc_k._finish(int(l_data), n, 0) == zlib.crc32(d.tobytes())
        B = adler_k.DEVICE_BLOCK
        pad = (-n) % B
        s_t, w_t = adler_k._get_blocks_fn(B)(jnp.pad(dd, (pad, 0)).reshape(-1, B))
        assert isinstance(s_t, jax.Array) and s_t.shape == ()
        s1 = (1 + int(s_t)) % adler_k.MOD
        s2 = (n % adler_k.MOD + int(w_t)) % adler_k.MOD
        assert (s2 << 16 | s1) == zlib.adler32(d.tobytes())


@pytest.mark.gpu
def test_checksums_on_gpu(gpu, rng):
    """On a card: the compiled kernel's forms equal the plain forms, and
    the device checksum paths agree with zlib on 64 MiB."""
    import jax.numpy as jnp

    from tpuzlib.kernels import crc32_pallas

    d = rng.integers(0, 256, 64 << 20, dtype=np.uint8)
    blocks = jnp.asarray(d).reshape(-1, crc32_pallas.BLOCK)
    assert np.array_equal(
        np.asarray(crc32_pallas.forms(blocks)), np.asarray(crc_k.forms_xla(blocks))
    )
    assert crc_k.crc32_device(d, 5) == zlib.crc32(d.tobytes(), 5)
    assert adler_k.adler32_device(d) == zlib.adler32(d.tobytes())
