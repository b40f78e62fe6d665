"""Public decompression API: Inflater / inflate().

Parity with reference src/sd-inflate.ts: Inflater option validation
(:60-80), chunked append drive loop (:87-153), NEED_DICT handling
(:116-126), finish() verdict (:159-179), one-shot inflate() with
container auto-detect (:189-228).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..common import mergeBuffers, u8_view
from ..codec.tokenize import DataError
from ..containers.inflate_container import ContainerInflater, NeedDictionary


@dataclass
class InflateResult:
    """Parity with reference InflateResult (sd-inflate.ts:39-52)."""

    success: bool
    complete: bool
    checksum: str  # "match" | "mismatch" | "unchecked"
    fileSize: str  # "match" | "mismatch" | "unchecked"
    fileName: str
    modDate: Optional[datetime.datetime]


@dataclass
class InflaterOptions:
    """Parity with reference InflaterOptions (sd-inflate.ts:17-37)."""

    raw: bool = False
    dictionary: object = None


class Inflater:
    def __init__(self, options: InflaterOptions | None = None, **kwargs):
        if options is None:
            options = InflaterOptions(**kwargs)
        elif kwargs:
            raise TypeError("pass either an options object or keyword options")
        raw = options.raw
        if raw is None:
            raw = False
        if not isinstance(raw, bool):
            raise TypeError("options.raw must be undefined or true or false")
        dictionary = options.dictionary
        if dictionary is not None:
            if raw:
                raise ValueError(
                    "options.dictionary cannot be set when options.raw is true"
                )
            try:
                dictionary = u8_view(dictionary)
            except TypeError:
                raise TypeError(
                    "options.dictionary must be undefined or a buffer or a buffer view"
                )
        self._container = ContainerInflater(raw, dictionary)
        self._finished = False
        self._total_in = 0

    @property
    def total_in(self) -> int:
        """Bytes consumed so far (ZStream.total_in parity)."""
        return self._total_in

    @property
    def total_out(self) -> int:
        """Decompressed bytes produced so far (ZStream.total_out)."""
        return self._container.total_out

    def append(self, data) -> list[np.ndarray]:
        """Feed a chunk of compressed data; returns decompressed buffers."""
        if self._finished:
            raise RuntimeError("Inflater instances cannot be reused")
        try:
            view = u8_view(data)
        except TypeError:
            raise TypeError("data must be an ArrayBuffer or buffer view")
        if self._container.is_complete and len(view):
            # the stream (incl. trailer) already ended: an append that
            # consumes nothing is an error (sd-inflate.ts:130-132)
            raise ValueError("inflate error: bad input data")
        self._total_in += len(view)
        from ..utils.trace import timed_stage

        try:
            with timed_stage("inflate.append", len(view)):
                out = self._container.push(view)
        except NeedDictionary as nd:
            if nd.args[0] == "required":
                raise ValueError("Custom dictionary required for this data")
            raise ValueError("Custom dictionary is not valid for this data")
        except DataError as e:
            raise ValueError("inflate error: %s" % e)
        return [out] if len(out) else []

    def finish(self) -> InflateResult:
        """Verdict logic parity with sd-inflate.ts:159-179."""
        self._finished = True
        c = self._container
        stored_checksum = c.stored_checksum
        stored_size = c.stored_isize
        complete = c.is_complete
        checksum = (
            "unchecked"
            if stored_checksum == 0
            else ("match" if stored_checksum == c.output_checksum else "mismatch")
        )
        file_size = (
            "unchecked"
            if stored_size == 0
            else (
                "match"
                if stored_size == (c.total_out & 0xFFFFFFFF)
                else "mismatch"
            )
        )
        success = complete and checksum != "mismatch" and file_size != "mismatch"
        mod_date = (
            None
            if c.mtime == 0
            else datetime.datetime.fromtimestamp(c.mtime, datetime.timezone.utc)
        )
        return InflateResult(
            success=success,
            complete=complete,
            checksum=checksum,
            fileSize=file_size,
            fileName=c.file_name,
            modDate=mod_date,
        )


DEVICE_MIN_BYTES = 2 << 20  # compressed-size threshold for device dispatch


def _log_mismatch_fallback():
    import logging

    logging.getLogger("tpuzlib").warning(
        "device inflate produced a checksum mismatch; re-decoding on the "
        "host for the authoritative verdict"
    )


def _inflate_device_oneshot(input_, dictionary):
    """Container-aware device decompression (cursor-parallel v2).

    Returns decompressed bytes, or None when the device path declines
    (size gate, a container it does not take, or the data-dependent
    declines of inflate_device_v2: failed discovery or speculation, cap
    overflow).  Fallbacks are counted and logged, never silent; compile
    and runtime errors of the device program propagate.

    DISPATCH POLICY: device decode is OPT-IN via TPUZLIB_DEVICE=1 until a
    measured crossover against the host paths decides it."""
    import os
    import struct

    from ..utils import trace

    env = os.environ.get("TPUZLIB_DEVICE", "")
    if env != "1":
        return None
    if len(input_) < (1 << 18):
        return None
    from ..kernels.inflate_device2 import inflate_device_v2

    b0, b1 = int(input_[0]), int(input_[1])
    if b0 == 0x1F and b1 == 0x8B:
        c = ContainerInflater(raw=False)
        consumed = c._try_parse_gzip_header(input_)
        if consumed is None:
            return None
        payload = np.ascontiguousarray(input_[consumed:-8])
        stored_crc, isize = struct.unpack("<II", input_[-8:].tobytes())
        out = inflate_device_v2(
            payload, dictionary=dictionary, size_hint=isize + 1024
        )
        if out is None:
            trace.count("inflate.device_fallback")
            return None
        from .checksums import crc32

        if crc32(out) != stored_crc or (len(out) & 0xFFFFFFFF) != isize:
            # a device-path mismatch cannot distinguish a corrupt
            # stream from a speculation bug — the HOST path settles
            # it and renders the user-facing verdict
            trace.count("inflate.device_mismatch_fallback")
            _log_mismatch_fallback()
            return None
    elif b0 == 0x78 and ((b0 << 8) + b1) % 31 == 0 and not (b1 & 0x20):
        payload = np.ascontiguousarray(input_[2:-4])
        stored_adler = struct.unpack(">I", input_[-4:].tobytes())[0]
        out = inflate_device_v2(payload, dictionary=dictionary)
        if out is None:
            trace.count("inflate.device_fallback")
            return None
        from .checksums import adler32

        if adler32(out) != stored_adler:
            trace.count("inflate.device_mismatch_fallback")
            _log_mismatch_fallback()
            return None
    else:
        return None  # raw / FDICT containers stay on the host paths
    trace.count("inflate.device", len(out))
    return out


def inflate(data, dictionary=None) -> np.ndarray:
    """One-shot decompress with container auto-detection.

    Parity with sd-inflate.ts:189-228 (incl. the detection rule: zlib only
    when the first byte is exactly 0x78)."""
    from ..utils.mem import tune_malloc

    tune_malloc()  # large codec buffers must not be munmap'd per call
    input_ = u8_view(data)
    if len(input_) < 2:
        raise ValueError("data buffer is too small")
    # with device dispatch on, large one-shot streams decode on the
    # device (cursor-parallel v2) with the same logged-fallback
    # discipline as below
    device_out = _inflate_device_oneshot(input_, dictionary)
    if device_out is not None:
        return device_out
    # many-core hosts: large streams decode via speculative segment
    # parallelism (checksum-verified); a codec-level failure falls back
    # (with a logged warning, never silently) to the standard path for
    # exact reference error semantics.  TPUZLIB_SPECULATIVE=1 forces the
    # dispatch (tests); =0 disables it.
    import os

    try:
        ncores = len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover
        ncores = os.cpu_count() or 1
    spec_env = os.environ.get("TPUZLIB_SPECULATIVE", "")
    use_spec = (
        spec_env == "1"
        or (spec_env != "0" and ncores >= 8 and len(input_) >= (16 << 20))
    )
    if use_spec:
        from ..parallel.speculative import inflate_parallel_container

        try:
            return inflate_parallel_container(input_, dictionary=dictionary)
        except ValueError:
            # real verdicts (checksum mismatch, NEED_DICT surface) carry
            # reference-parity messages already — propagate them
            raise
        except Exception as e:
            import logging

            logging.getLogger("tpuzlib").warning(
                "speculative inflate failed (%s: %s); falling back to the "
                "sequential path", type(e).__name__, e,
            )
    method, flag = int(input_[0]), int(input_[1])
    starts_with_ident = (
        method == 0x78 and ((method << 8) + flag) % 31 == 0
    ) or (method == 0x1F and flag == 0x8B)
    inflater = Inflater(InflaterOptions(raw=not starts_with_ident, dictionary=dictionary))
    if method == 0x1F and flag == 0x8B and len(input_) >= 18:
        # whole gzip stream in hand: the trailer ISIZE (mod 2^32) is an
        # exact allocation hint for the native decoder
        import struct

        isize = struct.unpack("<I", input_[-4:].tobytes())[0]
        inflater._container.engine.size_hint = isize + 64
    buffers = inflater.append(input_)
    result = inflater.finish()
    if not result.success:
        if not result.complete:
            raise ValueError("Unexpected EOF during decompression")
        if result.checksum == "mismatch":
            raise ValueError("Data integrity check failed")
        if result.fileSize == "mismatch":
            raise ValueError("Data size check failed")
        raise ValueError("Decompression error")
    return mergeBuffers(buffers)
