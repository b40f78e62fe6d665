#!/usr/bin/env python
"""Smoke test of tpuzlib's device path through its public entry points.

    python chip_smoke.py                  # one GPU, real sizes
    python chip_smoke.py --four           # four GPUs: the sharded mesh path
    python chip_smoke.py --cpu-rehearsal  # shrunk sizes on the CPU backend

Run it from the repository root.  Phases on one GPU (inputs generated
from --seed by tpuzlib.corpus):

  1. device   — the card (nvidia-smi), jax.devices(), each device_kind;
  2. checksums— tpuzlib.crc32 / tpuzlib.adler32 over 256 MiB (device
                dispatch) against zlib;
  3. deflate  — tpuzlib.deflate(level=6, format="gzip") with device
                dispatch on 64 MiB of text and 16 MiB of mixed text and
                random data; gzip.decompress must return the input;
  4. inflate  — tpuzlib.inflate of a stdlib gzip level-6 stream and of
                phase 3's own output, byte-exact;
  5. streaming— DeviceDeflater fed 16 MiB in 1 MiB appends, decoded by
                zlib;
  6. memory   — compiled.memory_analysis() of the v3 encode step and of
                the tokenize step, and the device's peak bytes in use.

--four runs only the mesh path on four GPUs: sharded_deflate over 64 MiB
(16 MiB per shard) with the mesh-combined adler32/crc32 checked against
zlib, sharded_inflate of the result, and the one-device
deflate_device_v3 of the same input to compare with.

Every phase checks its output and the trace counters (device bytes
counted, no fallback).  Any failure exits non-zero with no result line.
The last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
import zlib

MiB = 1 << 20


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def once(name, fn, nbytes):
    """One timed call (compile included when its programs are new)."""
    out, t = timed(fn)
    print(f"[{name}] one call {t:.3f} s ({nbytes / t / 1e6:.1f} MB/s)",
          flush=True)
    return out


def cold_warm(name, fn, nbytes):
    """Run fn twice: the first call compiles, the second is warm."""
    out, cold = timed(fn)
    out, warm = timed(fn)
    print(
        f"[{name}] first call {cold:.3f} s (compile + run), warm {warm:.3f} s"
        f" ({nbytes / warm / 1e6:.1f} MB/s), compile ~{max(cold - warm, 0):.3f} s",
        flush=True,
    )
    return out


def card_line():
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def counters_ok(trace, key, nbytes):
    c = trace.get_counters()
    bad = {k: v for k, v in c.items() if k.endswith("fallback") and v}
    check(not bad, f"fallback counters non-zero: {bad}")
    check(c.get(key, 0) >= nbytes, f"{key} counted {c.get(key, 0)} < {nbytes}")
    trace.reset_counters()


def phase_checksums(tpuzlib, corpus, trace, size, seed):
    import numpy as np

    data = np.frombuffer(corpus.random_bytes(size, seed), np.uint8)
    crc = cold_warm("crc32", lambda: tpuzlib.crc32(data), size)
    check(crc == zlib.crc32(data), "crc32 != zlib.crc32")
    adler = cold_warm("adler32", lambda: tpuzlib.adler32(data), size)
    check(adler == zlib.adler32(data), "adler32 != zlib.adler32")
    counters_ok(trace, "crc32.device", 2 * size)
    print(f"[checksums] {size} bytes: crc32 {crc:08x}, adler32 {adler:08x}"
          " equal to zlib", flush=True)


def phase_deflate(tpuzlib, trace, name, data):
    out = cold_warm(
        f"deflate {name}",
        lambda: tpuzlib.deflate(data, level=6, format="gzip"),
        len(data),
    )
    wire = bytes(out)
    check(gzip.decompress(wire) == data, f"deflate {name}: gzip round trip")
    ref = len(zlib.compress(data, 6))
    print(f"[deflate {name}] {len(data)} bytes -> {len(wire)} (stdlib zlib "
          f"level 6: {ref}, ratio {len(wire) / ref:.4f})", flush=True)
    counters_ok(trace, "deflate.device", 2 * len(data))
    return wire


def phase_inflate(tpuzlib, trace, name, wire, data, tok_calls):
    tok_calls.clear()
    out = cold_warm(f"inflate {name}", lambda: tpuzlib.inflate(wire), len(data))
    check(bytes(out) == data, f"inflate {name}: output differs")
    counters_ok(trace, "inflate.device", 2 * len(data))
    t = tok_calls[-1]
    print(
        f"[inflate {name}] {len(wire)} -> {len(data)} bytes; tokenize "
        f"K={t['K']} CAP={t['CAP']}: while_loop iterations ~{t['iters']} "
        f"(max tokens per cursor), warm tokenize {t['s']:.4f} s = "
        f"{t['s'] / max(t['iters'], 1) * 1e6:.2f} us/iteration", flush=True,
    )


def phase_streaming(tpuzlib, trace, data, piece):
    def run():
        d = tpuzlib.DeviceDeflater(level=6)
        outs = [d.append(data[i : i + piece]) for i in range(0, len(data), piece)]
        outs.append(d.finish())
        return b"".join(bytes(o) for o in outs)

    raw = cold_warm("streaming", run, len(data))
    check(zlib.decompress(raw, -15) == data, "DeviceDeflater round trip")
    counters_ok(trace, "deflate.device", 2 * len(data))
    print(f"[streaming] {len(data)} bytes in {piece}-byte appends -> "
          f"{len(raw)} bytes", flush=True)


def spy_tokenizer(jax, idv, calls):
    """Wrap the cursor tokenizer to record its shapes, warm device time
    and iteration count (the loop runs until the longest cursor stops)."""
    import numpy as np

    make = idv.make_cursor_tokenize

    def make_spied(K, CAP):
        fn = make(K, CAP)

        def call(*args):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            calls.append(dict(
                fn=fn, args=args, K=K, CAP=CAP, s=time.perf_counter() - t0,
                iters=int(np.max(np.asarray(out[2]))),
            ))
            return out

        return call

    idv.make_cursor_tokenize = make_spied


def phase_memory(jax, tok_calls):
    import jax.numpy as jnp

    from tpuzlib.kernels import deflate_device3 as d3

    chunk, batch = 1 << 18, 8
    ow = min(chunk + 4, (chunk * 10) // 32 + 64)
    enc = d3._get(("enc3", 6, chunk, batch, ow),
                  lambda: d3.make_encode_batch_v3(6, chunk, batch, ow))
    args = (
        jax.ShapeDtypeStruct((batch, d3.CTX + chunk), jnp.uint8),
        *(jax.ShapeDtypeStruct((batch,), jnp.int32),) * 3,
    )
    print("[memory] v3 encode step (batch 8 x 256 KiB):",
          enc.lower(*args).compile().memory_analysis(), flush=True)
    t = tok_calls[-1]
    print(f"[memory] tokenize step (K={t['K']}, CAP={t['CAP']}):",
          t["fn"].lower(*t["args"]).compile().memory_analysis(), flush=True)
    for d in jax.local_devices():
        stats = d.memory_stats() or {}
        print(f"[memory] {d}: peak_bytes_in_use "
              f"{stats.get('peak_bytes_in_use', 'not reported')}", flush=True)


def run_one(args, jax, tpuzlib, corpus, trace):
    big, mixed, stream, cks = (
        (2 * MiB, 1 * MiB + 12345, 2 * MiB, 2 * MiB) if args.cpu_rehearsal
        else (64 * MiB, 16 * MiB, 16 * MiB, 256 * MiB)
    )
    piece = stream // 16
    from tpuzlib.kernels import inflate_device2 as idv

    tok_calls = []
    spy_tokenizer(jax, idv, tok_calls)
    trace.reset_counters()

    phase_checksums(tpuzlib, corpus, trace, cks, args.seed)
    text = corpus.text(big, args.seed)
    own = phase_deflate(tpuzlib, trace, "text", text)
    phase_deflate(tpuzlib, trace, "mixed", corpus.mixed(mixed, args.seed + 1))
    std = gzip.compress(text, 6, mtime=0)
    phase_inflate(tpuzlib, trace, "stdlib-gzip", std, text, tok_calls)
    phase_inflate(tpuzlib, trace, "own-gzip", own, text, tok_calls)
    phase_streaming(tpuzlib, trace, corpus.text(stream, args.seed + 2), piece)
    phase_memory(jax, tok_calls)


def run_four(args, jax, corpus):
    import numpy as np

    from tpuzlib.kernels.deflate_device3 import deflate_device_v3
    from tpuzlib.parallel import make_mesh, sharded_deflate, sharded_inflate

    n = (1 * MiB if args.cpu_rehearsal else 64 * MiB) - 777
    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    mesh = make_mesh(4)
    data = corpus.text(n, args.seed)
    arr = np.frombuffer(data, np.uint8)
    out, adler, crc = cold_warm(
        "sharded_deflate x4", lambda: sharded_deflate(arr, mesh, level=6), n
    )
    wire = bytes(out)
    check(zlib.decompress(wire) == data, "sharded_deflate: zlib round trip")
    check(adler == zlib.adler32(data), "mesh adler32 != zlib.adler32")
    check(crc == zlib.crc32(data), "mesh crc32 != zlib.crc32")
    print(f"[four] mesh adler32 {adler:08x} and crc32 {crc:08x} equal to zlib",
          flush=True)
    payload = np.frombuffer(wire[2:-4], np.uint8)
    back = once(
        "sharded_inflate x4",
        lambda: sharded_inflate(payload, mesh, size_hint=n + 1024), n,
    )
    check(back is not None, "sharded_inflate declined")
    check(bytes(back) == data, "sharded_inflate output differs")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in devs]
    print(f"[four] peak_bytes_in_use per device: {peaks}", flush=True)
    if not args.cpu_rehearsal:
        check(min(peaks) > max(peaks) // 4,
              "the mesh work did not spread over the four devices")
    one = once("deflate_device_v3 x1", lambda: deflate_device_v3(arr), n)
    check(zlib.decompress(bytes(one), -15) == data, "one-device v3 round trip")
    print(f"[four] {n} bytes: sharded x4 -> {len(wire) - 6} raw bytes, one "
          f"device -> {len(one)} raw bytes, stdlib zlib level 6 -> "
          f"{len(zlib.compress(data, 6)) - 6}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four", action="store_true",
                   help="run only the sharded mesh path on four GPUs")
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="shrunk sizes on the CPU backend (interpret-mode Pallas)")
    args = p.parse_args(argv)

    if args.cpu_rehearsal:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["TPUZLIB_DEVICE_CHECKSUM_THRESHOLD"] = str(1 * MiB)
        if args.four:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            )
    os.environ["TPUZLIB_DEVICE"] = "1"
    try:
        import jax

        import tpuzlib
        from tpuzlib import corpus
        from tpuzlib.utils import trace
        from tpuzlib.utils.jaxcache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the codec ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 2

    enable_compile_cache()
    devs = jax.devices()
    platform = devs[0].platform
    print(f"[device] jax {jax.__version__}: {devs}", flush=True)
    for d in devs:
        print(f"[device] {d.id}: {d.device_kind}", flush=True)
    if platform != "gpu" and not args.cpu_rehearsal:
        print(f"chip_smoke: no GPU found (platform {platform!r})",
              file=sys.stderr)
        return 1
    print("[device] card:", card_line() if platform == "gpu"
          else "none (CPU rehearsal)", flush=True)

    t0 = time.perf_counter()
    try:
        if args.four:
            run_four(args, jax, corpus)
        else:
            run_one(args, jax, tpuzlib, corpus, trace)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind, "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
