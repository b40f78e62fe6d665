"""Multi-device sharding: mesh setup, sharded codec pipelines, halo
exchange, in-mesh checksum combines, ordered gather."""

from .mesh import make_mesh, make_multihost_mesh
from .pipeline import build_sharded_deflate, sharded_deflate, sharded_inflate
from .members import compress_members, decompress_members
from .speculative import inflate_parallel, inflate_parallel_container

__all__ = [
    "make_mesh",
    "make_multihost_mesh",
    "build_sharded_deflate",
    "sharded_deflate",
    "sharded_inflate",
    "compress_members",
    "decompress_members",
    "inflate_parallel",
    "inflate_parallel_container",
]
