"""Device mesh construction for multi-chip encode/decode.

The reference has no distributed layer (goroutine pool only,
/root/reference/encoder.go:690-742); here tiles shard over a
jax.sharding.Mesh: 'dp' = independent tiles/images (embarrassingly parallel
— JPEG 2000 tiles are coded independently), 'sp' = spatial row sharding
within a tile with DWT halo exchange between devices (SURVEY.md §5.7).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              sp: Optional[int] = None) -> Mesh:
    """Build a (dp, sp) mesh over the available devices.

    Default split: as many 'dp' (tile-parallel) groups as possible with
    sp=2 spatial groups when the device count is even and >= 4.
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = devices[:n]
    if dp is None or sp is None:
        if n >= 4 and n % 2 == 0:
            sp = sp or 2
            dp = dp or n // sp
        else:
            dp, sp = n, 1
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    arr = np.array(devices).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """[B, H, W, ...] batch: B over dp, H over sp."""
    return NamedSharding(mesh, P("dp", "sp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
