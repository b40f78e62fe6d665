"""v3 device deflate tests (CPU backend).

The v3 encoder is the flagship device program: sort-carried matching,
shifted-compare screens, d-chain long-match resolution, sort-based
histogram/pack, RLE'd dynamic headers, host stored-block fallback.
Oracle: python-zlib decode + size comparisons (reference parity:
deflate.ts:827-1182 semantics)."""

import zlib

import numpy as np
import pytest

from tpuzlib import corpus

TEXT = corpus.artifact("paradiselost.txt")


def _v3(data, level=6, chunk=1 << 18, batch=2):
    from tpuzlib.kernels.deflate_device3 import deflate_device_v3

    return deflate_device_v3(
        np.frombuffer(data, np.uint8) if isinstance(data, bytes) else data,
        level=level,
        chunk=chunk,
        batch=batch,
    )


def _zlib_raw(data, level=6):
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def test_v3_text_roundtrip_and_size():
    wire = _v3(TEXT)
    assert zlib.decompress(bytes(wire), -15) == TEXT
    # corpus size invariant: <= stdlib zlib raw deflate at the same level
    assert len(wire) <= len(_zlib_raw(TEXT))


def test_v3_vertices_roundtrip_and_size():
    src = zlib.decompress(corpus.artifact("vertices.deflate"))
    wire = _v3(src)
    assert zlib.decompress(bytes(wire), -15) == src
    # corpus size invariant: <= stdlib zlib raw deflate at the same level
    assert len(wire) <= len(_zlib_raw(src))


def test_v3_batched_chunk_must_align_to_segments():
    from tpuzlib.kernels.deflate_device import SEG
    from tpuzlib.kernels.deflate_device3 import make_encode_batch_v3

    with pytest.raises(ValueError, match="multiple"):
        make_encode_batch_v3(6, SEG + 1024, 2, 4096)
    make_encode_batch_v3(6, SEG + 1024, 1, 4096)  # one chunk: any length


def test_v3_incompressible_stored_fallback():
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, 300000, dtype=np.uint8).tobytes()
    wire = _v3(src)
    assert zlib.decompress(bytes(wire), -15) == src
    # stored blocks: bounded overhead over raw size
    assert len(wire) <= len(src) + 64


def test_v3_runs_and_periodic_roundtrip():
    rng = np.random.default_rng(8)
    for src in (
        b"\x00" * 400000,
        np.tile(rng.integers(0, 256, 12, dtype=np.uint8), 30000).tobytes(),
        np.tile(rng.integers(0, 256, 1024, dtype=np.uint8), 200).tobytes(),
    ):
        wire = _v3(src)
        assert zlib.decompress(bytes(wire), -15) == src
        # runs must compress to under 2% (d-chain correctness; the SEG
        # forced-break overhead keeps this above zlib's ratio on pure
        # runs — documented trade, PARITY.md)
        assert len(wire) < len(src) // 50


def test_v3_partial_chunk_and_levels():
    src = TEXT[: (1 << 18) + 12345]  # exercises n_valid masking
    for level in (1, 6, 9):
        wire = _v3(src, level=level)
        assert zlib.decompress(bytes(wire), -15) == src


def test_v3_mixed_content():
    rng = np.random.default_rng(9)
    src = (
        TEXT[:100000]
        + rng.integers(0, 256, 60000, dtype=np.uint8).tobytes()
        + b"\x00" * 40000
        + TEXT[:62144]
    )
    wire = _v3(src)
    assert zlib.decompress(bytes(wire), -15) == src


def _windows(data):
    import jax.numpy as jnp

    from tpuzlib.kernels.deflate_device import _build_w32

    w0 = _build_w32(jnp, jnp.asarray(data))
    return [w0] + [
        jnp.concatenate([w0[k:], jnp.zeros(k, jnp.uint32)]) for k in (4, 8, 12)
    ]


def _prefix(data, i, j, cap):
    pl = 0
    while pl < cap and data[i + pl] == data[j + pl]:
        pl += 1
    return pl


def test_v3_screens_match_bruteforce():
    """Near screen agrees with a brute-force oracle on low-entropy data
    (packed key: screen length, then closeness)."""
    import jax.numpy as jnp

    from tpuzlib.kernels.deflate_device3 import near_screen

    rng = np.random.default_rng(1)
    total = 1024
    data = rng.integers(0, 4, total).astype(np.uint8)
    mincand = jnp.zeros(total, jnp.int32)
    lim16 = jnp.clip(total - jnp.arange(total), 0, 16).astype(jnp.int32)
    nd = 8
    best = np.asarray(near_screen(jnp, _windows(data), mincand, lim16, nd))
    sc = best >> 16
    d = np.where(best > 0, 0xFFFF - (best & 0xFFFF), 0)
    for i in range(0, total, 7):
        bsc, bd = 0, 0
        for dd in range(1, nd + 1):
            if i - dd < 0:
                break
            pl = _prefix(data, i, i - dd, min(16, total - i))
            if pl >= 3 and pl > bsc:
                bsc, bd = pl, dd
        assert bsc == sc[i] and (bsc == 0 or bd == d[i]), (i, sc[i], d[i], bsc, bd)


def test_v3_far_screen_matches_bruteforce():
    """Far (sorted-domain) screen: each row's best among its k sorted
    predecessors with the same hash, a distance in 1..32768, and a
    16-byte prefix of at least 3."""
    import jax
    import jax.numpy as jnp

    from tpuzlib.kernels.deflate_device3 import far_screen

    rng = np.random.default_rng(2)
    total, k = 2048, 6
    data = rng.integers(0, 3, total + 16).astype(np.uint8)
    w = _windows(data)
    h = jnp.asarray(rng.integers(0, 5, total + 16).astype(np.int32))
    pos = jnp.arange(total + 16, dtype=jnp.int32)
    sh, sp, *s = jax.lax.sort((h, pos, *w), num_keys=1, is_stable=True)
    best = np.asarray(far_screen(jnp, sh, sp, s, k))
    shn, spn = np.asarray(sh), np.asarray(sp)
    for r in range(0, total + 16, 5):
        want = 0
        for j in range(1, k + 1):
            if r - j < 0 or shn[r - j] != shn[r]:
                continue
            dist = int(spn[r] - spn[r - j])
            if not 1 <= dist <= 32768:
                continue
            p, q = int(spn[r]), int(spn[r - j])
            pl = _prefix(np.concatenate([data, np.full(16, 255, np.uint8)]),
                         p, q, 16)
            pl = min(pl, 16)
            # past the data end the windows hold zero bytes on both sides
            if pl >= 3:
                want = max(want, (pl << 16) | (0xFFFF - dist))
        assert best[r] == want or spn[r] + 16 > total + 16, (r, best[r], want)


def test_v3_screen_far_offset():
    """Shifted compares reach back across any offset: matches whose
    candidates sit just before a position deep into the array (65536)
    are found at the exact distance."""
    import jax.numpy as jnp

    from tpuzlib.kernels.deflate_device3 import near_screen

    span = 1 << 16
    total = span + 4 * 128
    data = np.zeros(total, np.uint8)
    pat = np.asarray([7, 11, 13], np.uint8)
    data[span - 30 : span + 30] = np.tile(pat, 20)
    mincand = jnp.zeros(total, jnp.int32)
    lim16 = jnp.clip(total - jnp.arange(total), 0, 16).astype(jnp.int32)
    best = np.asarray(near_screen(jnp, _windows(data), mincand, lim16, 8))
    for i in range(span - 2, span + 20):
        sc = best[i] >> 16
        d = 0xFFFF - (best[i] & 0xFFFF)
        assert sc >= 3 and d == 3, (i, sc, d)


def test_pack_fields_matches_symbols_and_tables():
    """Token bit fields == sym_fields_v2 decomposition + per-chunk code
    table lookups, assembled LSB first (pad tokens emit nothing)."""
    import jax
    import jax.numpy as jnp

    from tpuzlib.kernels.deflate_device import sym_fields_v2
    from tpuzlib.kernels.deflate_device3 import pack_fields

    rng = np.random.default_rng(4)
    B, T = 2, 512
    ism = rng.random((B, T)) < 0.5
    lit = np.where(ism, rng.integers(3, 259, (B, T)), rng.integers(0, 257, (B, T)))
    dist = rng.integers(1, 32769, (B, T))
    tok = (lit | (ism << 9) | (np.where(ism, dist - 1, 0) << 10)).astype(np.uint32)
    tok[:, -7:] = 511
    lb = rng.integers(1, 16, (B, 286)).astype(np.int32)
    lc = (rng.integers(0, 1 << 15, (B, 286)) & ((1 << lb) - 1)).astype(np.uint32)
    db = rng.integers(1, 16, (B, 30)).astype(np.int32)
    dc = (rng.integers(0, 1 << 15, (B, 30)) & ((1 << db) - 1)).astype(np.uint32)
    lo, hi, nb = (
        np.asarray(v) for v in pack_fields(
            jax, jnp, *(jnp.asarray(v) for v in (tok, lc, lb, dc, db))
        )
    )
    ll = np.asarray(tok & 0x1FF, np.int64)
    m = ((tok >> 9) & 1) == 1
    dd = np.where(m, (tok >> 10).astype(np.int64) + 1, 0)
    lsym, lext, lval, dsym, dext, dval = (
        np.asarray(v) for v in sym_fields_v2(
            jax, jnp, jnp.asarray(ll), jnp.asarray(dd), jnp.asarray(m)
        )
    )
    for b in range(B):
        for t in range(T):
            if ll[b, t] == 511:
                assert nb[b, t] == 0 and lo[b, t] == 0 and hi[b, t] == 0
                continue
            s, n = int(lc[b, lsym[b, t]]), int(lb[b, lsym[b, t]])
            s |= int(lval[b, t]) << n
            n += int(lext[b, t])
            if m[b, t]:
                s |= int(dc[b, dsym[b, t]]) << n
                n += int(db[b, dsym[b, t]])
                s |= int(dval[b, t]) << n
                n += int(dext[b, t])
            assert nb[b, t] == n
            assert (int(hi[b, t]) << 32 | int(lo[b, t])) == s, (b, t)


def test_device_deflater_streaming_state():
    """Device-resident streaming state: the match window is carried
    across append() calls ON DEVICE, and cross-append matches are found
    (parity contract: reference window persistence deflate.ts:110-194)."""
    import zlib

    from tpuzlib.kernels.deflate_device3 import DeviceDeflater

    chunk = 1 << 14
    d = DeviceDeflater(level=6, chunk=chunk, batch=2)
    parts = [TEXT[i : i + 40000] for i in range(0, 200000, 40000)]
    outs = [d.append(p) for p in parts]
    outs.append(d.finish())
    wire = b"".join(bytes(o) for o in outs if len(o))
    assert zlib.decompress(wire, -15) == TEXT[:200000]
    # cross-append matches: the stream must be smaller than
    # independent compression of the parts (history reuse)
    indep = sum(
        len(zlib.compress(p, 6)) - 10 for p in parts
    )
    assert len(wire) < indep


def test_device_deflater_public_export():
    """DeviceDeflater is part of the public surface (lazy attr)."""
    import tpuzlib

    assert tpuzlib.DeviceDeflater.__name__ == "DeviceDeflater"
    # NOT in __all__: `from tpuzlib import *` must never pull in jax
    # (round-3 advisor finding); discoverable via dir() instead
    assert "DeviceDeflater" not in tpuzlib.__all__
    assert "DeviceDeflater" in dir(tpuzlib)
