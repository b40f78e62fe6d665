"""tpuzlib — a data-parallel DEFLATE codec framework in JAX.

A compression library with the full capabilities of stardazed/sd-zlib
(the reference; src/sd-zlib.ts:39-43 export surface): deflate/inflate
with raw, zlib and gzip containers, streaming chunked
``Deflater``/``Inflater`` APIs, compression levels 1-9, preset
dictionaries, and incremental adler32/crc32 checksums.

Unlike the reference (a sequential byte-stream codec), tpuzlib is designed
as an SPMD pipeline for an accelerator (a GPU): checksums are
GF(2)/modular linear algebra with integer matrix products, LZ77 match
search + parse are vectorized data-parallel passes, Huffman bit packing
uses prefix-sum scatter, and inflate is a two-pass parallel decoder
(tokenize, then data-parallel expansion with pointer-doubling LZ
resolution).  Independent chunks shard across a ``jax.sharding.Mesh``.

Public API (parity with reference dist/sd-zlib.d.ts):
    inflate, Inflater, InflaterOptions, InflateResult
    deflate, Deflater, DeflaterOptions
    adler32, crc32, mergeBuffers
"""

from .common import mergeBuffers, u8_view
from .api.checksums import adler32, crc32
from .api.inflate_api import Inflater, InflaterOptions, inflate, InflateResult
from .api.deflate_api import Deflater, DeflaterOptions, deflate


def __getattr__(name):
    # DeviceDeflater is the streaming compressor with device-resident
    # codec state (kernels/deflate_device3.py); imported lazily so that
    # plain host use never touches jax
    if name == "DeviceDeflater":
        from .kernels.deflate_device3 import DeviceDeflater

        return DeviceDeflater
    raise AttributeError(name)

__version__ = "0.1.0"

# DeviceDeflater is deliberately NOT in __all__: `from tpuzlib import *`
# must never trigger the lazy jax import (host-only users).  It remains
# available as an opt-in attribute and is listed in __dir__ below.
__all__ = [
    "adler32",
    "crc32",
    "mergeBuffers",
    "u8_view",
    "Inflater",
    "InflaterOptions",
    "inflate",
    "InflateResult",
    "Deflater",
    "DeflaterOptions",
    "deflate",
]


def __dir__():
    return sorted(set(globals()) | {"DeviceDeflater"})
