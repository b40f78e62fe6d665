"""Mesh construction helpers.

The codec's parallelism is one-dimensional data parallelism over
independent compressed units ("shards" axis) with nearest-neighbor halo
flow — the window context moves by ppermute, checksums combine via
bit-planed psum (SURVEY.md §2 parallelism inventory).  Every device
reaches every other at the same rate, so the mesh is one axis."""

from __future__ import annotations

import numpy as np


def make_mesh(n_devices: int | None = None, platform: str | None = None):
    import jax
    from jax.sharding import Mesh

    devices = jax.devices(platform) if platform else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("shards",))


def make_multihost_mesh(platform: str | None = None):
    """Mesh over every device of a multi-process run.

    Calls jax.distributed.initialize() when launched under a multi-host
    runtime (JAX coordinator env vars present); shard placement follows
    process order so the in-order gather (pipeline.py) reproduces stream
    order across hosts."""
    import os

    import jax

    if (
        jax.process_count() == 1
        and os.environ.get("JAX_COORDINATOR_ADDRESS")
        and not jax.distributed.is_initialized()
    ):
        jax.distributed.initialize()
    return make_mesh(platform=platform)
