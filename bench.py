#!/usr/bin/env python
"""tpuzlib benchmark — prints ONE JSON line.

Host section (any machine): repeated one-shot deflate/inflate of the
seeded text corpus (tpuzlib.corpus, 471,162 bytes) with device dispatch
off, extremes trimmed, as the reference's perf harness does
(test/perf.html:23-37), plus a 32 MiB run.

Device section (GPU only; elsewhere every device metric is reported as
"not measured"): warm wall times that end in block_until_ready or in the
host bytes a caller receives, for the checksums on 256 MiB of
device-resident data, one v3 encode step (8 x 256 KiB), and the device
deflate/inflate paths on 8 MiB.  Every result names the platform, the
device kind and count, and the card with its power limit.
"""

import json
import subprocess
import sys
import time
import zlib

import numpy as np


def timed(fn, reps=10):
    fn()  # warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    trimmed = times[1:-1] if len(times) > 4 else times
    return sum(trimmed) / len(trimmed)


def best_of(fn, reps=3):
    fn()  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        return None


def host_section(tpuzlib, txt, extras):
    n = len(txt)
    wire6 = bytes(tpuzlib.deflate(txt, level=6))
    t_deflate = timed(lambda: tpuzlib.deflate(txt, level=6), reps=12)
    extras["deflate_l6_ms"] = round(t_deflate * 1000, 3)
    extras["deflate_l6_size"] = len(wire6)
    extras["deflate_l6_size_vs_zlib"] = len(wire6) - len(zlib.compress(txt, 6))
    t_inflate = timed(lambda: tpuzlib.inflate(wire6), reps=12)
    extras["inflate_MBps"] = round(n / t_inflate / 1e6, 3)

    from tpuzlib import corpus

    big = corpus.text(32 << 20, 1)
    cbig = tpuzlib.deflate(big, level=6)
    assert bytes(tpuzlib.inflate(cbig)) == big
    extras["deflate_l6_32MB_MBps"] = round(
        len(big) / best_of(lambda: tpuzlib.deflate(big, level=6)) / 1e6, 3
    )
    extras["inflate_32MB_MBps"] = round(
        len(big) / best_of(lambda: tpuzlib.inflate(cbig)) / 1e6, 3
    )
    return n / t_deflate / 1e6


def device_section(jax, tpuzlib, extras):
    import os

    import jax.numpy as jnp

    from tpuzlib import corpus
    from tpuzlib.kernels import adler32 as adler_k
    from tpuzlib.kernels import crc32 as crc_k
    from tpuzlib.kernels.deflate_device import CTX
    from tpuzlib.kernels.deflate_device3 import (
        deflate_device_v3,
        make_encode_batch_v3,
    )
    from tpuzlib.kernels.inflate_device2 import inflate_device_v2
    from tpuzlib.utils import trace

    def wait(f):
        return lambda *a: jax.block_until_ready(f(*a))

    # checksums on device-resident data
    n = 256 << 20
    data = jax.device_put(jnp.asarray(np.frombuffer(corpus.random_bytes(n), np.uint8)))
    crc_fn = wait(jax.jit(crc_k.linear_form_device))
    t = best_of(lambda: crc_fn(data))
    extras["device_crc32_256MB_ms"] = round(t * 1e3, 4)
    blocks = data.reshape(-1, adler_k.DEVICE_BLOCK)
    adler_fn = wait(adler_k._get_blocks_fn(adler_k.DEVICE_BLOCK))
    t = best_of(lambda: adler_fn(blocks))
    extras["device_adler32_256MB_ms"] = round(t * 1e3, 4)
    del data, blocks

    # one v3 encode step
    chunk, batch = 1 << 18, 8
    out_words = min(chunk + 4, (chunk * 10) // 32 + 64)
    enc = wait(make_encode_batch_v3(6, chunk, batch, out_words))
    text = np.frombuffer(corpus.text(batch * (CTX + chunk), 3), np.uint8)
    args = (
        jnp.asarray(text.reshape(batch, CTX + chunk)),
        jnp.full(batch, CTX, jnp.int32),
        jnp.full(batch, chunk, jnp.int32),
        jnp.zeros(batch, jnp.int32),
    )
    t = best_of(lambda: enc(*args))
    extras["device_encode_step_ms"] = round(t * 1e3, 4)
    extras["device_encode_step_MBps"] = round(batch * chunk / t / 1e6, 3)

    # device codec paths, host bytes in to host bytes out
    src = corpus.text(8 << 20, 2)
    arr = np.frombuffer(src, np.uint8)
    t = best_of(lambda: deflate_device_v3(arr))
    extras["device_deflate_8MB_MBps"] = round(len(src) / t / 1e6, 3)
    payload = np.frombuffer(zlib.compress(src, 6)[2:-4], np.uint8)
    out = inflate_device_v2(payload, size_hint=len(src) + 1024)
    assert out is not None and bytes(out) == src, "device inflate declined"
    t = best_of(lambda: inflate_device_v2(payload, size_hint=len(src) + 1024))
    extras["device_inflate_8MB_MBps"] = round(len(src) / t / 1e6, 3)

    prev = os.environ.get("TPUZLIB_DEVICE")
    os.environ["TPUZLIB_DEVICE"] = "1"
    try:
        trace.reset_counters()
        wire = bytes(tpuzlib.deflate(src, level=6))
        t = best_of(lambda: tpuzlib.deflate(src, level=6))
        extras["device_api_deflate_8MB_MBps"] = round(len(src) / t / 1e6, 3)
        assert bytes(tpuzlib.inflate(wire)) == src
        t = best_of(lambda: tpuzlib.inflate(wire))
        extras["device_api_inflate_8MB_MBps"] = round(len(src) / t / 1e6, 3)
        c = trace.get_counters()
        extras["device_api_fallbacks"] = int(
            c.get("deflate.device_fallback", 0) + c.get("inflate.device_fallback", 0)
        )
    finally:
        if prev is None:
            os.environ.pop("TPUZLIB_DEVICE", None)
        else:
            os.environ["TPUZLIB_DEVICE"] = prev


def main():
    import os

    os.environ["TPUZLIB_DEVICE"] = "0"  # host section: host paths only
    import jax

    import tpuzlib
    from tpuzlib import corpus
    from tpuzlib.utils.jaxcache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    extras = {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card() if devs[0].platform == "gpu" else None,
    }
    deflate_mbps = host_section(tpuzlib, corpus.artifact("paradiselost.txt"), extras)
    del os.environ["TPUZLIB_DEVICE"]
    if devs[0].platform == "gpu":
        device_section(jax, tpuzlib, extras)
    else:
        extras["device_metrics"] = "not measured (no GPU)"
    print(json.dumps({
        "metric": "deflate_l6_throughput",
        "value": round(deflate_mbps, 3),
        "unit": "MB/s",
        "extras": extras,
    }))


if __name__ == "__main__":
    sys.exit(main())
