"""Public compression API: Deflater / deflate().

Parity with reference src/sd-deflate.ts: option validation (:60-96),
zlib header writer (:98-115), gzip header writer with FNAME + MTIME
(:117-152), adler/crc + ISIZE trailer writer (:154-165), chunked append
(:173-221), finish (:228-253), one-shot deflate() (:263-274).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..common import mergeBuffers, u8_view
from ..codec.deflate_engine import DeflateEngine
from ..containers.headers import (
    make_gzip_header,
    make_gzip_trailer,
    make_zlib_header,
    make_zlib_trailer,
)
from ..kernels.adler32 import adler32_host
from ..kernels.crc32 import crc32_host

FORMATS = ("raw", "deflate", "gzip")


@dataclass
class DeflaterOptions:
    """Parity with reference DeflaterOptions (sd-deflate.ts:17-49)."""

    format: str = "deflate"
    level: int = 6
    dictionary: object = None
    fileName: Optional[str] = None


class Deflater:
    def __init__(self, options: DeflaterOptions | None = None, **kwargs):
        if options is None:
            options = DeflaterOptions(**kwargs)
        elif kwargs:
            raise TypeError("pass either an options object or keyword options")
        level = options.level
        if not isinstance(level, int) or isinstance(level, bool) or not (
            1 <= level <= 9
        ):
            raise ValueError("level must be between 1 and 9, inclusive")
        if options.format not in FORMATS:
            raise ValueError("container must be one of `raw`, `deflate`, `gzip`")
        if options.fileName is not None and not isinstance(options.fileName, str):
            raise TypeError("fileName must be a string")
        dictionary = options.dictionary
        if dictionary is not None:
            if options.format != "deflate":
                raise TypeError("Can only provide a dictionary for `deflate` containers.")
            try:
                dictionary = u8_view(dictionary)
            except TypeError:
                raise TypeError("dictionary must be an ArrayBuffer or buffer view")
        self.format = options.format
        self.level = level
        self.file_name = options.fileName
        self.dictionary = dictionary
        self.engine = DeflateEngine(level, dictionary)
        self.checksum = 1 if self.format == "deflate" else 0
        self.orig_size = 0
        self.compressed_size = 0
        self._started = False
        self._finished = False

    @property
    def total_in(self) -> int:
        """Bytes consumed so far (parity with ZStream.total_in,
        zstream.ts:24)."""
        return self.orig_size

    @property
    def total_out(self) -> int:
        """Compressed bytes produced so far (ZStream.total_out)."""
        return self.compressed_size

    def _header(self) -> np.ndarray:
        if self.format == "deflate":
            dict_id = (
                adler32_host(self.dictionary) if self.dictionary is not None else None
            )
            return u8_view(make_zlib_header(self.level, dict_id))
        if self.format == "gzip":
            return u8_view(make_gzip_header(self.file_name, level=self.level))
        return np.empty(0, dtype=np.uint8)

    def append(self, data) -> list[np.ndarray]:
        if self._finished:
            raise RuntimeError("Deflater instances cannot be reused")
        try:
            view = u8_view(data)
        except TypeError:
            raise TypeError("data must be an ArrayBuffer or buffer view")
        buffers = []
        if not self._started:
            self._started = True
            hdr = self._header()
            if len(hdr):
                buffers.append(hdr)
        if self.format == "deflate":
            self.checksum = adler32_host(view, self.checksum)
        elif self.format == "gzip":
            self.checksum = crc32_host(view, self.checksum)
        self.orig_size += len(view)
        from ..utils.trace import timed_stage

        with timed_stage("deflate.append", len(view)):
            out = self.engine.push(view)
        if len(out):
            buffers.append(out)
        self.compressed_size += sum(len(b) for b in buffers)
        return buffers

    def finish(self) -> list[np.ndarray]:
        if self._finished:
            raise RuntimeError("Deflater instances cannot be reused")
        if not self._started:
            raise RuntimeError("Cannot call finish before at least 1 call to append")
        self._finished = True
        from ..utils.trace import timed_stage

        with timed_stage("deflate.finish"):
            buffers = [self.engine.finish()]
        if self.format == "deflate":
            buffers.append(u8_view(make_zlib_trailer(self.checksum)))
        elif self.format == "gzip":
            buffers.append(u8_view(make_gzip_trailer(self.checksum, self.orig_size)))
        buffers = [b for b in buffers if len(b)]
        self.compressed_size += sum(len(b) for b in buffers)
        return buffers


DEVICE_MIN_BYTES = 4 << 20  # one-shot device dispatch threshold


def _device_backend_ready() -> bool:
    """True when device dispatch is explicitly enabled.

    DISPATCH POLICY: device compression is OPT-IN via TPUZLIB_DEVICE=1
    until a measured crossover against the host engine decides it."""
    import os

    return os.environ.get("TPUZLIB_DEVICE", "") == "1"


def _deflate_device_oneshot(view, options) -> Optional[np.ndarray]:
    """Whole-input device compression with host container framing.

    Returns the full wire bytes, or None when the device path declines
    (size, options, or a chunk over the encoder's token/output caps).
    Every outcome is counted in utils.trace; declines are logged, never
    silent.  Compile and runtime errors of the device program propagate:
    they are faults, not data-dependent declines."""
    import os

    from ..utils import trace

    if options.dictionary is not None:
        return None
    if len(view) < (
        1 << 20 if os.environ.get("TPUZLIB_DEVICE") == "1" else DEVICE_MIN_BYTES
    ):
        return None
    if not _device_backend_ready():
        return None
    from ..kernels.deflate_device3 import deflate_device_v3

    body = deflate_device_v3(np.ascontiguousarray(view), level=options.level)
    if body is None:
        trace.count("deflate.device_fallback")
        import logging

        logging.getLogger("tpuzlib").warning(
            "device deflate declined (token/output cap); host path used"
        )
        return None
    trace.count("deflate.device", len(view))
    buffers = []
    checksum = None
    if options.format == "deflate":
        buffers.append(u8_view(make_zlib_header(options.level, None)))
        checksum = adler32_host(view, 1)
    elif options.format == "gzip":
        buffers.append(
            u8_view(make_gzip_header(options.fileName, level=options.level))
        )
        checksum = crc32_host(view, 0)
    buffers.append(u8_view(body))
    if options.format == "deflate":
        buffers.append(u8_view(make_zlib_trailer(checksum)))
    elif options.format == "gzip":
        buffers.append(u8_view(make_gzip_trailer(checksum, len(view))))
    return mergeBuffers(buffers)


def deflate(data, options: DeflaterOptions | None = None, **kwargs) -> np.ndarray:
    """One-shot compress (parity with sd-deflate.ts:263-274).

    With TPUZLIB_DEVICE=1, inputs >= 1 MiB route to the v3 device
    encoder (kernels/deflate_device3.py) with host container framing;
    by default (or when the device path declines) the host engine runs —
    see _device_backend_ready for the dispatch policy."""
    from ..utils.mem import tune_malloc

    tune_malloc()  # large codec buffers must not be munmap'd per call
    try:
        view = u8_view(data)
    except TypeError:
        raise TypeError("data must be an ArrayBuffer or buffer view")
    deflater = Deflater(options, **kwargs)  # validates options first
    opts = DeflaterOptions(
        format=deflater.format,
        level=deflater.level,
        dictionary=deflater.dictionary,
        fileName=deflater.file_name,
    )
    out = _deflate_device_oneshot(view, opts)
    if out is not None:
        return out
    buffers = deflater.append(view)
    buffers += deflater.finish()
    return mergeBuffers(buffers)
