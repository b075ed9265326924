"""Device half of the HT cleanup DECODE path (VERDICT r4 next #2).

The cleanup decode splits into a sequentially-coupled control phase and a
data phase:

  - control (host, native C++ `ht_t2_parse_frames`): T2 packet walk + MEL +
    CxtVLC + UVLC.  Every decision depends on previously decoded contexts
    and the line-state exponents, so it stays scalar — but it touches only
    ~1 word per QUAD (4 samples) plus the (small) VLC stream.
  - data (here, device): per-SAMPLE MagSgn extraction.  Given the per-quad
    (U, rho, ek, e1) words, every sample's field length
    m_n = rho_n ? U - ek_n : 0 is known, so field offsets are one prefix
    sum and the extraction is a flat gather from the unstuffed word pool —
    a data-parallel shape.  Fused with block->pyramid assembly and the
    inverse DWT in ONE program, the decode side never uploads raw
    coefficient planes.

Capability bar: the reference's full HT decoder
(/root/reference/internal/entropy/ht.go:93-864), which runs scalar per
sample on one goroutine; this is its vectorized twin, split at the
control/data boundary.
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np

import jax
import jax.numpy as jnp


def magsgn_decode_blocks(qinfo, pool, woff, cbh: int, cbw: int):
    """Per-sample MagSgn extraction.

    qinfo: uint32 [NB, QH, QW] packed U | rho<<8 | ek<<12 | e1<<16 (0 for
    uncoded quads); pool: uint32 [P] unstuffed MagSgn words; woff: int32
    [NB] per-block word offsets into pool.  Returns int32 [NB, cbh, cbw]
    signed coefficients (value = sign * (floor(v/2) + 1), T.814 7.3.5).
    """
    nb, qh, qw = qinfo.shape
    q = qinfo.astype(jnp.uint32)
    U = (q & 0xFF).astype(jnp.int32)
    rho = ((q >> 8) & 0xF).astype(jnp.int32)
    ek = ((q >> 12) & 0xF).astype(jnp.int32)
    e1 = ((q >> 16) & 0xF).astype(jnp.int32)

    i4 = jnp.arange(4, dtype=jnp.int32)
    sig = (rho[..., None] >> i4) & 1                     # [NB, QH, QW, 4]
    ekn = (ek[..., None] >> i4) & 1
    e1n = (e1[..., None] >> i4) & 1
    m = jnp.where(sig == 1, U[..., None] - ekn, 0)       # field bits

    flat_m = m.reshape(nb, qh * qw * 4)
    off = jnp.cumsum(flat_m, axis=1) - flat_m            # exclusive
    goff = off + woff.astype(jnp.int32)[:, None] * 32    # absolute bit pos
    wi = (goff >> 5).reshape(-1)
    sh = (goff & 31).reshape(-1).astype(jnp.uint32)
    lo = jnp.take(pool, wi, mode="clip") >> sh
    hi = jnp.where(sh > 0,
                   jnp.take(pool, wi + 1, mode="clip") << ((32 - sh) & 31),
                   jnp.uint32(0))
    mm = flat_m.reshape(-1).astype(jnp.uint32)
    val = (lo | hi) & ((jnp.uint32(1) << mm) - jnp.uint32(1))
    v = val | (e1n.reshape(-1).astype(jnp.uint32) << mm)
    mu = ((v >> 1) + 1).astype(jnp.int32)
    neg = (v & 1).astype(jnp.int32)
    c = jnp.where(sig.reshape(-1) == 1,
                  jnp.where(neg == 1, -mu, mu), 0)
    c = c.reshape(nb, qh, qw, 4)

    # in-quad sample order n0..n3 = (row, col) (0,0),(1,0),(0,1),(1,1)
    top = jnp.stack([c[..., 0], c[..., 2]], axis=-1).reshape(nb, qh, qw * 2)
    bot = jnp.stack([c[..., 1], c[..., 3]], axis=-1).reshape(nb, qh, qw * 2)
    out = jnp.stack([top, bot], axis=2).reshape(nb, qh * 2, qw * 2)
    return out[:, :cbh, :cbw]


def blocks_to_pyramid_dev(coeffs, plan, n: int, n_comps: int, nl: int,
                          dequant: bool = False):
    """Device twin of models/decoder._blocks_to_pyramid: padded block slots
    [N*nb, CBH, CBW] -> stacked pyramid leaves [N, C, bh, bw] (jnp),
    handling offset code-block grids (multi-tile plans).  dequant=True
    applies per-band midpoint dequantization (E.1.1.2, r = 0.5) for lossy
    plans carrying deltas."""
    levels = max(1, nl)
    coeffs = coeffs.reshape(n, plan.nb, plan.cbh, plan.cbw)
    stacked = [dict() for _ in range(levels)]
    per_band = {}
    base = 0
    for bi, (c, lev, name, gy, gx, eh, ew, bh, bw, oy, ox) in \
            enumerate(plan.band_specs):
        blk = coeffs[:, base:base + gy * gx, :eh, :ew]
        base += gy * gx
        if dequant:
            qa = jnp.abs(blk).astype(jnp.float32)
            blk = jnp.where(blk == 0, jnp.float32(0),
                            jnp.sign(blk).astype(jnp.float32)
                            * (qa + 0.5) * jnp.float32(plan.deltas[bi]))
        blk = blk.reshape(n, gy, gx, eh, ew)
        if oy:
            blk = jnp.concatenate(
                [jnp.roll(blk[:, :1], oy, axis=-2), blk[:, 1:]], axis=1)
        if ox:
            blk = jnp.concatenate(
                [jnp.roll(blk[:, :, :1], ox, axis=-1), blk[:, :, 1:]],
                axis=2)
        a = (blk.transpose(0, 1, 3, 2, 4)
             .reshape(n, gy * eh, gx * ew)[:, oy:oy + bh, ox:ox + bw])
        per_band.setdefault((lev, name), []).append(a)
    for (lev, name), comps in per_band.items():
        arr = jnp.stack(comps, axis=1)        # [N, C, bh, bw]
        li = (nl - 1 if name == "LL" and nl > 0 else
              (lev - 1 if name != "LL" else 0))
        stacked[li][name] = arr
    return stacked


@functools.lru_cache(maxsize=64)
def fused_decode_fn(n: int, n_comps: int, nl: int, plan_key: int,
                    precision: int, signed: bool, use_mct: bool,
                    pool_words: int, kind: str = "REV53"):
    """ONE XLA program: (qinfo, pool, woff) -> narrow pixel bytes (flat).

    MagSgn extraction + block->pyramid assembly + [midpoint dequant +]
    inverse DWT (5/3 or 9/7) + inverse MCT + DC shift + clamp + narrowing.
    The only uploads are the quad-info words (~1 B/px) and the MagSgn pool
    (~the compressed stream); the only download is the final narrow pixels.
    """
    from ..models.fused_encode import _PLANS
    from . import dwt, mct
    plan = _PLANS[plan_key]
    lossy = kind == dwt.IRR97

    def fn(qinfo, pool, woff):
        blocks = magsgn_decode_blocks(qinfo, pool, woff, plan.cbh, plan.cbw)
        pyr = blocks_to_pyramid_dev(blocks, plan, n, n_comps, nl,
                                    dequant=lossy)
        x = dwt.reconstruct(pyr, kind)
        if use_mct and n_comps >= 3:
            if lossy:
                r, g, b = mct.inverse_ict(x[:, 0], x[:, 1], x[:, 2])
            else:
                r, g, b = mct.inverse_rct(x[:, 0], x[:, 1], x[:, 2])
            rest = [x[:, i] for i in range(3, n_comps)]
            x = jnp.stack([r, g, b] + rest, axis=1)
        if lossy:
            x = jnp.rint(x).astype(jnp.int32)
        if not signed:
            x = x + (1 << (precision - 1))
        x = mct.clamp_to_precision(x, precision, signed)
        if precision <= 8:
            x = x.astype(jnp.int8 if signed else jnp.uint8)
        elif precision <= 16:
            x = x.astype(jnp.int16 if signed else jnp.uint16)
        return x.reshape(-1)

    return jax.jit(fn)
