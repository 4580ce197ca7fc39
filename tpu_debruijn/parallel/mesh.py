"""Device mesh helpers for the MSP-bucket shard axis."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

SHARDS = "shards"


def shard_axis() -> str:
    return SHARDS


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: all available).

    MSP buckets are hashed onto this axis; reads stream data-parallel over
    it.  The GPUs of one host are joined all to all by NVLink, so the
    device order does not matter.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SHARDS,))
