"""Public adler32/crc32 entry points with host/device dispatch.

Parity with reference src/adler32.ts:17-24 and src/crc32.ts:17-23:
``adler32(source, seed=1)``, ``crc32(source, seed=0)``; results chain by
feeding the previous checksum in as the next call's seed
(reference README.md:151-161).  Returns are unsigned 32-bit ints.
"""

from __future__ import annotations

import os

from ..common import u8_view
from ..kernels import adler32 as _adler
from ..kernels import crc32 as _crc
from ..utils import trace

# Below this size the host-to-device copy and the dispatch dwarf the
# work; pipelines with device-resident data call the kernels directly.
DEVICE_THRESHOLD = int(
    os.environ.get("TPUZLIB_DEVICE_CHECKSUM_THRESHOLD", 256 << 20)
)

_force_backend = None  # test hook: None | "host" | "device"


def _use_device(n: int) -> bool:
    if _force_backend == "host":
        return False
    if _force_backend == "device":
        return True
    return n >= DEVICE_THRESHOLD


def adler32(source, seed: int = 1) -> int:
    data = u8_view(source)
    if _use_device(len(data)):
        trace.count("adler32.device", len(data))
        return _adler.adler32_device(data, seed)
    return _adler.adler32_host(data, seed)


def crc32(source, seed: int = 0) -> int:
    data = u8_view(source)
    if _use_device(len(data)):
        trace.count("crc32.device", len(data))
        return _crc.crc32_device(data, seed)
    return _crc.crc32_host(data, seed)
