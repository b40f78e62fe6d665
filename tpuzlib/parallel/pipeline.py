"""Sharded codec pipelines over a jax Mesh (shard_map + collectives).

The "training step" of this framework: every device compresses its shard
of the input with the previous shard's tail as dictionary context.  The
SPMD program is one shard_map:

  1. halo exchange   — each shard sends its last `ctx` bytes to its right
                       neighbor (lax.ppermute): the reference's
                       preset-dictionary mechanism (deflate.ts:1184-1216)
                       generalized to chunk halos;
  2. local compress  — the FLAGSHIP v3 batched dynamic-Huffman encoder
                       (kernels/deflate_device3.make_encode_batch_v3:
                       match screens, d-chain, lazy parse,
                       package-merge trees, RLE headers, bucketed-OR
                       pack), one chunk per shard;
  3. checksum combine— per-shard adler (S, W) merged positionally with
                       psum; per-shard raw CRC linear forms shifted by
                       per-shard GF(2) suffix matrices and XOR-combined
                       via bit-planed psum;
  4. gather          — fixed-size packed words stay sharded; the host
                       performs the in-order bit-level join (BitSink),
                       reproducing mergeBuffers semantics (common.ts:116).
"""

from __future__ import annotations

import functools

import numpy as np

from ..kernels import crc32 as crc_k
from ..kernels.adler32 import MOD


def _shard_shift_matrix_bits(shard_len: int, ndev: int, n: int | None = None) -> np.ndarray:
    """(ndev, 32, 32) int32: bit matrix of A^(suffix_bytes) per shard.

    Shard i's raw CRC form must be shifted past the VALID bytes that
    follow it (n = total valid length; defaults to the full padded
    extent for back-compat)."""
    if n is None:
        n = shard_len * ndev
    mats = np.zeros((ndev, 32, 32), dtype=np.int32)
    for i in range(ndev):
        suffix = max(n - (i + 1) * shard_len, 0)
        cols = crc_k.shift_matrix(suffix)  # packed u32 cols
        bits = ((cols[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1)
        # bits[c, r] = bit r of column c; out_bit[r] = XOR_c in_bit[c]*bits[c,r]
        mats[i] = bits.astype(np.int32)
    return mats


@functools.lru_cache(maxsize=16)
def build_sharded_deflate(
    mesh, shard_len: int, level: int = 6, ctx: int | None = None,
):
    """Jitted SPMD deflate step over `mesh` ("shards" axis).

    Input: (ndev * shard_len,) uint8 (zero-padded past the valid length)
    plus the valid length n.  Returns per-shard packed words, bit
    counts, per-shard ok flags (0 = token/output cap overflow, host
    emits stored blocks for that shard), and stream-global adler32 and
    crc32 (replicated scalars).

    Each shard runs the FLAGSHIP v3 dynamic-Huffman encoder
    (deflate_device3.make_encode_batch_v3, B=1) on its chunk with the
    left neighbor's 32 KiB tail as halo context.
    Checksums cover only valid bytes (padding is rolled to the shard
    front, where zeros are free for both adler's end-weighted sums and
    the CRC linear form).  Cached per (mesh, shard_len, level, ctx), so
    repeated calls reuse one compiled program.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..kernels.deflate_device3 import make_encode_batch_v3

    ndev = mesh.devices.size
    if ctx is None:
        ctx = min(1 << 15, shard_len)
    out_words = min(shard_len + 4, (shard_len * 10) // 32 + 64)
    encode = make_encode_batch_v3(level, shard_len, 1, out_words, ctx=ctx)
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]
    def step(data_shard, my_shift_bits, n):
        idx = jax.lax.axis_index("shards")
        n_valid = jnp.clip(n - idx * shard_len, 0, shard_len)
        # 1. halo: last ctx bytes travel to the right neighbor
        tail = data_shard[-ctx:]
        halo = jax.lax.ppermute(tail, "shards", perm)
        # a shard with data (n_valid > 0, idx > 0) always has a fully
        # valid predecessor, so its halo is real history
        ctx_valid = jnp.where((idx == 0) | (n_valid == 0), 0, ctx)
        buf = jnp.concatenate([halo, data_shard])

        # 2. local compress: one v3 dynamic-Huffman chunk per shard
        last = (idx == ndev - 1).astype(jnp.int32)
        words2, nbits2, ok2 = encode(
            buf[None], ctx_valid[None], n_valid[None], last[None]
        )
        words, nbits, okf = words2[0], nbits2[0], ok2[0]

        # 3a. adler: positional merge of per-shard (S, W).  Padding is
        # rolled to the shard FRONT where zero bytes contribute nothing
        # (weights count from the shard's valid end).
        def mod_reduce(v):
            # v: (k,) int32 entries < 2^24; sum mod MOD without overflow
            while v.shape[0] > 1:
                pad = (-v.shape[0]) % 64
                v = jnp.pad(v, (0, pad))
                v = jnp.sum(v.reshape(-1, 64), axis=1) % MOD
            return v[0]

        pad_len = shard_len - n_valid
        pos = jnp.arange(shard_len, dtype=jnp.int32)
        masked = jnp.where(pos < n_valid, data_shard, 0)
        rolled = jnp.roll(masked, pad_len)
        x = rolled.astype(jnp.int32)
        w = jnp.arange(shard_len, 0, -1, dtype=jnp.int32)
        s_local = mod_reduce(jnp.sum(x.reshape(-1, 64), axis=1))
        wb = (x * (w % MOD)) % MOD  # products < 255*65521 < 2^31
        w_local = mod_reduce(jnp.sum(wb.reshape(-1, 64), axis=1) % MOD)
        suffix = jnp.clip(n - (idx + 1) * shard_len, 0, None) % MOD
        # w_global_contrib = w_local + suffix * s_local (mod-safe multiply)
        hi, lo = suffix >> 8, suffix & 0xFF
        term = ((s_local * hi) % MOD * 256 + s_local * lo) % MOD
        w_contrib = (w_local + term) % MOD
        s_global = jax.lax.psum(s_local, "shards") % MOD
        w_global = jax.lax.psum(w_contrib, "shards") % MOD

        # 3b. crc: shift local linear form by suffix matrix, XOR across
        # shards via bit-planed psum
        l_local = crc_k.linear_form_device(rolled.astype(jnp.uint8))
        in_bits = ((l_local >> jnp.arange(32, dtype=jnp.uint32)) & 1).astype(jnp.int32)
        out_bits = (
            jax.lax.dot_general(
                in_bits[None, :],
                my_shift_bits.reshape(32, 32),
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )[0]
            & 1
        )
        xor_bits = jax.lax.psum(out_bits, "shards") & 1
        l_global = jnp.sum(
            xor_bits.astype(jnp.uint32) << jnp.arange(32, dtype=jnp.uint32),
            dtype=jnp.uint32,
        )
        return (
            words, nbits[None], okf[None],
            s_global[None], w_global[None], l_global[None],
        )

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P("shards"), P("shards"), P()),
        out_specs=(P("shards"), P("shards"), P("shards"), P(), P(), P()),
        check_vma=False,
    )

    from jax.sharding import NamedSharding

    data_sharding = NamedSharding(mesh, P("shards"))
    jitted = jax.jit(lambda d, s, n: sharded(d, s, n))
    shift_cache = {}

    def run(data, n: int | None = None):
        # commit the input to the mesh so jit compiles for exactly these
        # devices (a subset mesh otherwise falls back to all devices)
        if n is None:
            n = int(data.shape[0])
        if n not in shift_cache:
            shift_cache[n] = jax.device_put(
                jnp.asarray(
                    _shard_shift_matrix_bits(shard_len, ndev, n)
                ).reshape(ndev * 32, 32),
                NamedSharding(mesh, P("shards")),
            )
        data = jax.device_put(data, data_sharding)
        return jitted(data, shift_cache[n], jnp.int32(n))

    return run, ctx


def sharded_deflate(
    data: np.ndarray, mesh, level: int = 6,
    shard_len: int | None = None,
):
    """Host wrapper: pad/shard input of ANY length, run the SPMD step,
    join bits, wrap in a zlib container with the mesh-combined adler32.

    Padding never reaches the output: each shard compresses only its
    valid bytes and checksums are computed over the valid region.  A
    shard whose v3 encode overflowed its caps (ok=0) or whose dynamic
    block lost to byte-aligned stored blocks is emitted as stored blocks
    on the host — the same per-chunk choice deflate_device_v3 makes
    (reference _tr_flush_block stored choice, deflate.ts:648)."""
    import jax.numpy as jnp

    from ..codec.bitsink import BitSink
    from ..containers.headers import make_zlib_header, make_zlib_trailer
    from ..common import u8_view
    from ..kernels.deflate_device3 import _push_stored

    ndev = mesh.devices.size
    n = len(data)
    if shard_len is None:
        shard_len = max(4096, -(-n // ndev))
        shard_len = (shard_len + 4095) & ~4095  # multiple of 4096
    total = shard_len * ndev
    padded = np.zeros(total, dtype=np.uint8)
    padded[:n] = data
    run, _ = build_sharded_deflate(mesh, shard_len, level)
    words, nbits, ok, s_g, w_g, l_g = run(jnp.asarray(padded), n)
    words = np.asarray(words).reshape(ndev, -1)
    nbits = np.asarray(nbits).reshape(ndev)
    ok = np.asarray(ok).reshape(ndev)

    sink = BitSink()
    for i in range(ndev):
        lo, hi = i * shard_len, min((i + 1) * shard_len, n)
        nv = max(hi - lo, 0)
        tb = int(nbits[i])
        nstored = max(1, -(-nv // 65535))
        stored_bits = 8 * nv + nstored * (3 + 32) + 8
        if nv and (not ok[i] or tb > stored_bits):
            _push_stored(sink, data[lo:hi], i == ndev - 1)
            continue
        if nv == 0 and i < ndev - 1:
            continue  # empty non-final shard: emit nothing
        if nv == 0:
            # empty final shard: final empty stored block closes the
            # stream (possible only when n == 0)
            _push_stored(sink, np.empty(0, np.uint8), True)
            continue
        nfull = tb >> 5
        if nfull:
            sink.push(
                words[i, :nfull].astype(np.uint64), np.full(nfull, 32, np.int64)
            )
        rem = tb & 31
        if rem:
            sink.push_scalar(int(words[i, nfull]) & ((1 << rem) - 1), rem)
    body, _, _ = sink.flush(final=True)

    s1 = (1 + int(s_g[0])) % MOD
    s2 = ((n % MOD) * 1 + int(w_g[0])) % MOD
    adler = (s2 << 16) | s1
    crc = (int(l_g[0]) ^ crc_k.gf2.apply(crc_k.shift_matrix(n), 0xFFFFFFFF)) ^ 0xFFFFFFFF

    header = u8_view(make_zlib_header(level))
    trailer = u8_view(make_zlib_trailer(adler))
    out = np.concatenate([header, body, trailer])
    return out, adler, crc & 0xFFFFFFFF


def sharded_inflate(data, mesh, stride_bits: int = 1 << 15,
                    max_cursors: int = 4096, size_hint: int | None = None,
                    dictionary=None):
    """Mesh-parallel raw-DEFLATE decode (the multi-device inflate path).

    Cursor-parallel speculative tokenization sharded over the mesh's
    "shards" axis (kernels/inflate_device2) — cursors are independent,
    so each device decodes its slice of bit-strides with the compressed
    stream replicated; splice validation, compaction and LZ expansion
    follow on the global arrays.  Returns decompressed bytes or None
    when the stream needs the host engine (caller falls back).

    Why only the tokenize stage shards: tokenization is >90% of the
    decode work and embarrassingly parallel over cursors.  The splice is
    O(K) on cursor metadata (tiny), and the LZ expansion resolves
    back-references by pointer doubling over the OUTPUT array — a
    DEFLATE ref may chain transitively through the full 32 KiB window of
    every earlier block (no FULL_FLUSH history wipe in general streams),
    so a sharded expansion would need an all-gather of the whole output
    per doubling step; the traffic of log2(n) all-gathers exceeds
    the replicated compute it saves at any realistic stream size.
    Scale-out across devices for inflate therefore comes from
    data-parallel INDEPENDENT units — concatenated gzip members
    (parallel/members.py) and full-flush chunk boundaries — exactly the
    seams the reference's framing exposes (SURVEY.md §2 P1)."""
    from ..kernels.inflate_device2 import inflate_device_v2

    return inflate_device_v2(
        data, dictionary=dictionary, stride_bits=stride_bits,
        max_cursors=max_cursors, size_hint=size_hint, mesh=mesh,
    )
