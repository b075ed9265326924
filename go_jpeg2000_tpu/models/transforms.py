"""Jitted, shape-cached device transform stages for the codec pipeline.

One compiled XLA program per (shape, levels, kind, ...) handles the whole
tile transform — DC shift + MCT + multi-level DWT (+ inverse) — so the
device sees a single dispatch per tile instead of per-op eager traffic.
Components of equal shape batch as [C, H, W] so the lifting vectorizes
across components.  The lifting is plain jnp (ops/dwt.py), which XLA fuses
into a few elementwise kernels per level.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp

from ..ops import dwt, mct
from ..utils.metrics import counters


@functools.lru_cache(maxsize=256)
def forward_transform(c: int, h: int, w: int, levels: int, kind: str,
                      use_mct: bool, precision: int, signed: bool,
                      u0: int, v0: int, quant_deltas: tuple = None):
    """Returns jitted fn: int32 [C, H, W] -> single flat array packing the
    whole pyramid (one device->host transfer instead of one per band).

    quant_deltas (lossy): per-leaf deadzone quantizer steps in tree-leaves
    order — quantization then runs ON DEVICE and the fetch carries int
    indices (int16 when precision <= 10) instead of float32 coefficients,
    halving the d2h bytes and dropping the host quant loop."""

    def fn(comps):
        x = comps.astype(jnp.int32)
        if not signed:
            x = x - (1 << (precision - 1))
        if use_mct and c >= 3:
            if kind == dwt.REV53:
                y, u, v = mct.forward_rct(x[0], x[1], x[2])
            else:
                y, u, v = mct.forward_ict(x[0], x[1], x[2])
            rest = [x[i] for i in range(3, c)]
            x = jnp.stack([y, u, v] + rest)
        if kind == dwt.IRR97:
            x = x.astype(jnp.float32)
        pyr = dwt.decompose(x, levels, kind, u0=u0, v0=v0)
        leaves = jax.tree_util.tree_leaves(pyr)
        if quant_deltas is not None:
            out = []
            for leaf, d in zip(leaves, quant_deltas):
                q = (jnp.sign(leaf)
                     * jnp.floor(jnp.abs(leaf) / jnp.float32(d))
                     ).astype(jnp.int32)
                if precision <= 10:
                    q = q.astype(jnp.int16)
                out.append(q.reshape(-1))
            return jnp.concatenate(out)
        return jnp.concatenate([l.reshape(-1) for l in leaves])

    return jax.jit(fn)


@functools.lru_cache(maxsize=256)
def inverse_transform(c: int, h: int, w: int, levels: int, kind: str,
                      use_mct: bool, precision: int, signed: bool,
                      u0: int, v0: int):
    """Returns jitted fn: pyramid pytree -> int32 [C, H', W'] clamped samples.

    `levels` is the number of kept levels (after ReduceResolution); u0/v0 are
    the kept-resolution origins.
    """

    def fn(pyramid):
        x = dwt.reconstruct(pyramid, kind, u0=u0, v0=v0)
        if use_mct and c >= 3:
            if kind == dwt.REV53:
                r, g, b = mct.inverse_rct(x[0], x[1], x[2])
            else:
                r, g, b = mct.inverse_ict(x[0], x[1], x[2])
            rest = [x[i] for i in range(3, c)]
            x = jnp.stack([r.astype(jnp.float32) if kind == dwt.IRR97 else r,
                           g, b] + rest)
        if kind == dwt.IRR97:
            x = jnp.rint(x).astype(jnp.int32)
        if not signed:
            x = x + (1 << (precision - 1))
        return mct.clamp_to_precision(x, precision, signed)

    return jax.jit(fn)


def run_forward(tile_data, levels: int, kind: str, use_mct: bool,
                precision: int, signed: bool, u0: int, v0: int,
                quant_deltas: tuple = None):
    """Host helper: stack comps, run the jitted transform, fetch the packed
    pyramid with one transfer and unflatten to numpy arrays.  With
    quant_deltas the leaves come back as quantized indices (see
    forward_transform)."""
    import numpy as np
    comps = np.stack(tile_data).astype(np.int32)
    c, h, w = comps.shape
    fn = forward_transform(c, h, w, levels, kind, use_mct, precision, signed,
                           u0, v0, quant_deltas=quant_deltas)
    flat = np.asarray(fn(comps))
    counters.add("enc.device_transform_frames")
    if flat.dtype == np.int16:
        flat = flat.astype(np.int32)
    # rebuild the pyramid structure from static shapes
    shapes = dwt.subband_shapes(h, w, levels, u0=u0, v0=v0)
    # tree_leaves order: list -> dicts with sorted keys
    pyr = []
    pos = 0
    for lev_shapes in shapes:
        entry = {}
        for k in sorted(lev_shapes.keys()):
            bh, bw = lev_shapes[k]
            n = c * bh * bw
            entry[k] = flat[pos:pos + n].reshape(c, bh, bw)
            pos += n
        pyr.append(entry)
    return pyr


@functools.lru_cache(maxsize=64)
def forward_transform_batch(n: int, c: int, h: int, w: int, levels: int,
                            kind: str, use_mct: bool, precision: int,
                            signed: bool, u0: int, v0: int):
    """Batched variant: int32 [N, C, H, W] -> packed flat pyramid, with MCT
    vectorized over the image axis.  One dispatch for a whole frame batch."""

    def fn(batch_flat):
        # flat upload: one contiguous h2d copy, reshaped on device
        x = batch_flat.reshape(n, c, h, w).astype(jnp.int32)
        if not signed:
            x = x - (1 << (precision - 1))
        if use_mct and c >= 3:
            if kind == dwt.REV53:
                y, u, v = mct.forward_rct(x[:, 0], x[:, 1], x[:, 2])
            else:
                y, u, v = mct.forward_ict(x[:, 0], x[:, 1], x[:, 2])
            rest = [x[:, i] for i in range(3, c)]
            x = jnp.stack([y, u, v] + rest, axis=1)
        if kind == dwt.IRR97:
            x = x.astype(jnp.float32)
        pyr = dwt.decompose(x, levels, kind, u0=u0, v0=v0)
        leaves = jax.tree_util.tree_leaves(pyr)
        flat = jnp.concatenate([l.reshape(-1) for l in leaves])
        if kind == dwt.REV53 and precision <= 13:
            flat = flat.astype(jnp.int16)
        return flat

    return jax.jit(fn)


def dispatch_forward_batch(batch, levels: int, kind: str, use_mct: bool,
                           precision: int, signed: bool, u0: int, v0: int):
    """Asynchronously dispatch the batched forward transform.

    `batch` keeps its native (narrow) dtype — the h2d transfer ships e.g.
    uint8 and the cast to int32 happens on device, cutting h2d bytes 4x.
    Starts the device->host copy immediately; pair with
    `fetch_forward_batch` to overlap host entropy with later chunks."""
    import numpy as np
    n, c, h, w = batch.shape
    fn = forward_transform_batch(n, c, h, w, levels, kind, use_mct,
                                 precision, signed, u0, v0)
    from ..utils import fetch
    out = fn(np.ascontiguousarray(batch).reshape(-1))
    counters.add("enc.device_transform_frames", n)
    return fetch.fetch_async(out)


def fetch_forward_batch(dev_flat, n: int, c: int, h: int, w: int,
                        levels: int, u0: int, v0: int):
    """Block on the packed pyramid, widen, and unflatten to per-frame
    numpy pyramids."""
    import numpy as np
    from ..utils import fetch
    flat = fetch.gather(dev_flat)
    if flat.dtype == np.int16:
        flat = flat.astype(np.int32)
    shapes = dwt.subband_shapes(h, w, levels, u0=u0, v0=v0)
    pyrs = [[] for _ in range(n)]
    pos = 0
    for lev_shapes in shapes:
        entries = [{} for _ in range(n)]
        for k in sorted(lev_shapes.keys()):
            bh, bw = lev_shapes[k]
            cnt = n * c * bh * bw
            block = flat[pos:pos + cnt].reshape(n, c, bh, bw)
            for i in range(n):
                entries[i][k] = block[i]
            pos += cnt
        for i in range(n):
            pyrs[i].append(entries[i])
    return pyrs


def run_forward_batch(batch, levels: int, kind: str, use_mct: bool,
                      precision: int, signed: bool, u0: int, v0: int):
    """batch: [N, C, H, W] -> list of N pyramids (numpy), one transfer."""
    n, c, h, w = batch.shape
    dev = dispatch_forward_batch(batch, levels, kind, use_mct, precision,
                                 signed, u0, v0)
    return fetch_forward_batch(dev, n, c, h, w, levels, u0, v0)


def run_inverse(pyramid, c: int, levels: int, kind: str, use_mct: bool,
                precision: int, signed: bool, u0: int, v0: int):
    import numpy as np
    if pyramid and "LL" in pyramid[-1]:
        h, w = pyramid[-1]["LL"].shape[-2:]
    else:
        h = w = 0
    fn = inverse_transform(c, h, w, levels, kind, use_mct, precision, signed,
                           u0, v0)
    out = np.asarray(fn(pyramid))
    counters.add("dec.device_transform_frames")
    return out


@functools.lru_cache(maxsize=64)
def inverse_transform_batch(n: int, c: int, levels: int, kind: str,
                            use_mct: bool, precision: int, signed: bool,
                            u0: int, v0: int,
                            flat_shapes: Tuple = ()):
    """Batched inverse: pyramid leaves [N, C, h, w] -> narrow [N, C, H, W].

    When `flat_shapes` is given (tuple of (level, band, h, w) in upload
    order), the jitted fn takes ONE flat array and splits it on device —
    a single h2d transfer instead of one per leaf (each transfer through
    host->device copy has a fixed cost)."""

    def split_flat(flat):
        pyramid = [dict() for _ in range(levels)]
        pos = 0
        for (lev, band, h, w) in flat_shapes:
            cnt = n * c * h * w
            pyramid[lev][band] = flat[pos:pos + cnt].reshape(n, c, h, w)
            pos += cnt
        return pyramid

    def fn(pyramid):
        if flat_shapes:
            pyramid = split_flat(pyramid)
        # leaves may arrive narrowed (int16) to cut h2d bytes; widen on device
        if kind == dwt.REV53:
            pyramid = jax.tree_util.tree_map(
                lambda l: l.astype(jnp.int32), pyramid)
        x = dwt.reconstruct(pyramid, kind, u0=u0, v0=v0)
        if use_mct and c >= 3:
            if kind == dwt.REV53:
                r, g, b = mct.inverse_rct(x[:, 0], x[:, 1], x[:, 2])
            else:
                r, g, b = mct.inverse_ict(x[:, 0], x[:, 1], x[:, 2])
            rest = [x[:, i] for i in range(3, c)]
            x = jnp.stack([r, g, b] + rest, axis=1)
        if kind == dwt.IRR97:
            x = jnp.rint(x).astype(jnp.int32)
        if not signed:
            x = x + (1 << (precision - 1))
        x = mct.clamp_to_precision(x, precision, signed)
        # narrow on device: cuts the device->host fetch up to 4x
        if precision <= 8:
            x = x.astype(jnp.int8 if signed else jnp.uint8)
        elif precision <= 16:
            x = x.astype(jnp.int16 if signed else jnp.uint16)
        # flat download (caller reshapes on host)
        return x.reshape(-1)

    return jax.jit(fn)


def dispatch_inverse_batch(pyramids, c: int, levels: int, kind: str,
                           use_mct: bool, precision: int, signed: bool,
                           u0: int, v0: int):
    """Async-dispatch the batched inverse; returns a device handle.

    Lossless pyramids with coefficients that fit int16 are narrowed on host
    before upload (halving h2d bytes); the jitted fn widens on
    device."""
    import numpy as np
    stacked = []
    for lev in range(len(pyramids[0])):
        stacked.append({k: np.stack([p[lev][k] for p in pyramids])
                        for k in pyramids[0][lev]})
    return dispatch_inverse_stacked(stacked, len(pyramids), c, levels, kind,
                                    use_mct, precision, signed, u0, v0)


def dispatch_inverse_stacked(stacked, n: int, c: int, levels: int, kind: str,
                             use_mct: bool, precision: int, signed: bool,
                             u0: int, v0: int):
    """Like dispatch_inverse_batch but takes pre-stacked leaves [N, C, h, w].

    One flat upload: every leaf rides a single h2d transfer (each separate
    transfer has a fixed cost)."""
    import numpy as np
    narrow = (kind == dwt.REV53 and precision <= 13)
    dt = np.int16 if narrow else (np.int32 if kind == dwt.REV53
                                  else np.float32)
    flat_shapes = []
    chunks = []
    for lev in range(len(stacked)):
        for k in sorted(stacked[lev]):
            a = stacked[lev][k].astype(dt)
            flat_shapes.append((lev, k) + a.shape[-2:])
            chunks.append(a.reshape(-1))
    flat = np.concatenate(chunks)
    fn = inverse_transform_batch(n, c, levels, kind, use_mct, precision,
                                 signed, u0, v0, tuple(flat_shapes))
    # async h2d so the upload overlaps other chunks' host entropy work
    from ..utils import fetch
    out = fn(jax.device_put(flat))
    counters.add("dec.device_transform_frames", n)
    return fetch.fetch_async(out)


def run_inverse_batch(pyramids, c: int, levels: int, kind: str, use_mct: bool,
                      precision: int, signed: bool, u0: int, v0: int):
    """pyramids: list of N per-frame pyramids (leaves [C, h, w]) -> ndarray
    [N, C, H, W], one device dispatch + one fetch."""
    from ..utils import fetch
    return fetch.gather(dispatch_inverse_batch(
        pyramids, c, levels, kind, use_mct, precision, signed, u0, v0))
