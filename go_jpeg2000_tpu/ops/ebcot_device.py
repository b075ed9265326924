"""Data-parallel EBCOT Tier-1 on the device: decision-field kernel.

SURVEY hard part #1: the reference's hottest code is the scalar
significance-propagation walk with inlined MQ
(/root/reference/internal/entropy/t1_fast5.go:10-899).  A data-parallel
device cannot run that walk as-is — within one pass, a sample's coding
decision depends on significance updates from samples visited earlier in
the stripe scan.  The kernel here removes the walk entirely:

* The scan-order "visited before me" relation for each of the 8 neighbor
  offsets is STATIC given the row-within-stripe r = y & 3 (e.g. W/N/NW
  neighbors always precede, E/S/SE never do, NE only when r == 0, SW only
  when r < 3).  So "neighbor state at visit time" = state-entering-pass OR
  (became-significant-this-pass AND statically-before) — pure vector ops.
* SPP membership is the one genuinely recursive quantity (a sample enters
  SPP if an earlier-visited neighbor just became significant); it is the
  least fixpoint of a monotone map, computed by lax.while_loop over whole
  [B, H, W] batches (iterations = longest propagation chain, typically a
  handful).
* MRP membership is closed-form: exactly the samples significant before
  this plane.  CUP significance updates are closed-form too (every
  still-insignificant 1-bit sample becomes significant), so cleanup
  run-length decisions and contexts need no fixpoint at all.

Output is a dense, statically-ordered decision array per block: one uint8
slot per potential decision, 0xFF when absent, value ctx | bit << 5
otherwise.  Flattened slot order equals the serial coder's emission order
exactly (plane desc -> SPP, MRP, CUP -> stripe -> column -> row -> intra-
sample slot), so `compact(slots)` is the block's exact (ctx, bit) MQ
decision stream — verified decision-for-decision against a traced
ops/t1.py oracle in tests/test_ebcot_device.py.

Supports the default coding style (no lazy/termall/VSC/segsym/reset —
config-1).  Styled blocks fall back to the host coder.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import t1 as t1_py

EMPTY = 0xFF          # slot sentinel: no decision
CTX_RL = 17
CTX_UNI = 18

# flat [3*3*3*5] int32 ZC table, index = band_class*45 + h*15 + v*5 + d
_ZC_FLAT = np.asarray(t1_py.ZC_LUT, np.int32).reshape(-1)
_SC_CTX = np.zeros((3, 3), np.int32)
_SC_XOR = np.zeros((3, 3), np.int32)
for (_hc, _vc), (_cx, _xr) in t1_py.SC_TABLE.items():
    _SC_CTX[_hc + 1, _vc + 1] = _cx
    _SC_XOR[_hc + 1, _vc + 1] = _xr

# neighbor offsets (dy, dx)
_OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))
_CARDINAL = {(-1, 0): "N", (1, 0): "S", (0, -1): "W", (0, 1): "E"}


def _shift_to(a, dy: int, dx: int):
    """[..., H, W] -> same shape; out[y, x] = a[y+dy, x+dx], False/0 pad."""
    h, w = a.shape[-2], a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 2) + [(1, 1), (1, 1)]
    ap = jnp.pad(a, pad)
    return jax.lax.slice(
        ap, (0,) * (a.ndim - 2) + (1 + dy, 1 + dx),
        a.shape[:-2] + (1 + dy + h, 1 + dx + w))


def _before_sample(dy: int, dx: int, r):
    """Is the (dy,dx) neighbor visited before this sample?  r = y & 3."""
    if (dy, dx) in ((-1, -1), (-1, 0), (0, -1)):
        return jnp.ones_like(r, bool)
    if (dy, dx) == (-1, 1):
        return r == 0
    if (dy, dx) == (1, -1):
        return r < 3
    return jnp.zeros_like(r, bool)          # E, S, SE


def _before_column(dy: int, dx: int, r):
    """Is the (dy,dx) neighbor coded before this sample's run-length COLUMN
    is evaluated?  (Same-column neighbors N at r>0 are part of the column
    itself and must not count.)"""
    if (dy, dx) in ((-1, -1), (0, -1)):
        return jnp.ones_like(r, bool)
    if (dy, dx) in ((-1, 0), (-1, 1)):
        return r == 0
    if (dy, dx) == (1, -1):
        return r < 3
    return jnp.zeros_like(r, bool)


def _neighbor_state(static_sig, new_sig, r, before_fn):
    """Per-offset dict: neighbor's significance as seen at visit time."""
    st = {}
    for (dy, dx) in _OFFS:
        st[(dy, dx)] = _shift_to(static_sig, dy, dx) | (
            _shift_to(new_sig, dy, dx) & before_fn(dy, dx, r))
    return st


def _zc_primary(h, v, d):
    """Table D-1 class-A rule (H primary), vectorized as where-chains
    instead of a 4.6M-element table gather."""
    return jnp.where(
        h == 2, 8,
        jnp.where(h == 1, jnp.where(v >= 1, 7, jnp.where(d >= 1, 6, 5)),
                  jnp.where(v == 2, 4,
                            jnp.where(v == 1, 3,
                                      jnp.where(d >= 2, 2,
                                                jnp.where(d == 1, 1, 0))))))


def _zc_hh(h, v, d):
    hv = h + v
    return jnp.where(
        d >= 3, 8,
        jnp.where(d == 2, jnp.where(hv >= 1, 7, 6),
                  jnp.where(d == 1,
                            jnp.where(hv >= 2, 5, jnp.where(hv == 1, 4, 3)),
                            jnp.where(hv >= 2, 2, jnp.where(hv == 1, 1, 0)))))


def _zc_ctx(nb, band_class):
    """nb: per-offset bool visit-state; band_class [B,1,1] int32."""
    i32 = lambda a: a.astype(jnp.int32)
    h = i32(nb[(0, -1)]) + i32(nb[(0, 1)])
    v = i32(nb[(-1, 0)]) + i32(nb[(1, 0)])
    d = (i32(nb[(-1, -1)]) + i32(nb[(-1, 1)])
         + i32(nb[(1, -1)]) + i32(nb[(1, 1)]))
    return jnp.where(band_class == 0, _zc_primary(h, v, d),
                     jnp.where(band_class == 1, _zc_primary(v, h, d),
                               _zc_hh(h, v, d)))


def _sc_ctx(nb, signs):
    """Sign-coding context + coded bit (Table D-3 closed form).
    signs: 1 = negative."""
    def contrib(dy, dx):
        s = _shift_to(signs, dy, dx)
        return jnp.where(nb[(dy, dx)], 1 - 2 * s, 0)
    hc = jnp.clip(contrib(0, -1) + contrib(0, 1), -1, 1)
    vc = jnp.clip(contrib(-1, 0) + contrib(1, 0), -1, 1)
    ctx = jnp.where(hc == 0, 9 + (vc != 0), 12 + hc * vc)
    xr = ((hc < 0) | ((hc == 0) & (vc < 0))).astype(signs.dtype)
    return ctx, signs ^ xr


def _slot(emit, ctx, bit):
    v = (ctx | (bit.astype(jnp.int32) << 5)).astype(jnp.uint8)
    return jnp.where(emit, v, jnp.uint8(EMPTY))


def _plane_slots(mags, signs, valid, band_class, r, p: int, live):
    """All decision slots of one bitplane, serial emission order.

    Returns (spp [B,G,W,4,2], mrp [B,G,W,4], cup [B,G,W,11])."""
    B, H, W = mags.shape
    G = H // 4
    s_in = ((mags >> (p + 1)) > 0) & valid & live
    bit = (((mags >> p) & 1) > 0) & valid & live

    # ---- significance propagation pass: membership fixpoint ----
    nb_sin = jnp.zeros_like(s_in)
    for (dy, dx) in _OFFS:
        nb_sin |= _shift_to(s_in, dy, dx)
    base = valid & live & ~s_in

    def cond(st):
        return st[1]

    def body(st):
        mem = st[0]
        new = mem & bit
        trig = jnp.zeros_like(mem)
        for (dy, dx) in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (1, -1)):
            trig |= _shift_to(new, dy, dx) & _before_sample(dy, dx, r)
        mem2 = base & (nb_sin | trig)
        return mem2, jnp.any(mem2 != mem)

    member, _ = jax.lax.while_loop(
        cond, body, (base & nb_sin, jnp.bool_(True)))
    new_spp = member & bit

    nbv = _neighbor_state(s_in, new_spp, r, _before_sample)
    zc = _zc_ctx(nbv, band_class)
    sc, sc_bit = _sc_ctx(nbv, signs)
    spp_a = _slot(member, zc, bit)
    spp_b = _slot(new_spp, sc, sc_bit)

    # ---- magnitude refinement pass (membership closed-form) ----
    sig_after = s_in | new_spp
    eta = ((mags >> (p + 2)) > 0) & valid
    nb_any = jnp.zeros_like(sig_after)
    for (dy, dx) in _OFFS:
        nb_any |= _shift_to(sig_after, dy, dx)
    mr = jnp.where(eta, 16, jnp.where(nb_any, 15, 14))
    mrp = _slot(s_in, mr, bit)

    # ---- cleanup pass ----
    cand = valid & live & ~s_in & ~member
    bc = cand & bit                         # becomes significant in CUP
    nbc = _neighbor_state(sig_after, bc, r, _before_column)
    col_clear = cand
    for (dy, dx) in _OFFS:
        col_clear &= ~nbc[(dy, dx)]
    yy = jax.lax.broadcasted_iota(jnp.int32, (1, H, 1), 1)
    hval = jnp.max(jnp.where(valid, yy + 1, 0), axis=(1, 2), keepdims=True)
    full_stripe = (yy - r + 4) <= hval      # stripe fully inside block

    def stripes(a):                         # [B,H,W] -> [B,G,4,W]
        return a.reshape(B, G, 4, W)

    rl = jnp.all(stripes(col_clear & full_stripe), axis=2)    # [B,G,W]
    colbit = stripes(bit)
    any_bit = jnp.any(colbit, axis=2)
    rr = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 4, 1), 2)
    fs = jnp.min(jnp.where(colbit, rr, 4), axis=2)            # [B,G,W]

    rl_slot = _slot(rl, jnp.int32(CTX_RL), any_bit)
    u1 = _slot(rl & any_bit, jnp.int32(CTX_UNI), (fs >> 1) & 1 > 0)
    u2 = _slot(rl & any_bit, jnp.int32(CTX_UNI), (fs & 1) > 0)

    in_rl = jnp.repeat(rl, 4, axis=1).reshape(B, H, W)
    fs_full = jnp.repeat(fs, 4, axis=1).reshape(B, H, W)
    zc_emit = cand & jnp.where(in_rl, r > fs_full, True)
    nbs = _neighbor_state(sig_after, bc, r, _before_sample)
    zc2 = _zc_ctx(nbs, band_class)
    sc2, sc2_bit = _sc_ctx(nbs, signs)
    cup_a = _slot(zc_emit, zc2, bit)
    sc_emit = (zc_emit & bit) | (in_rl & (r == fs_full) & (fs_full < 4))
    cup_b = _slot(sc_emit, sc2, sc2_bit)

    # layout: (B, G, W, slots) in scan order
    def col_major(a):                       # [B,H,W] -> [B,G,W,4]
        return a.reshape(B, G, 4, W).transpose(0, 1, 3, 2)

    spp = jnp.stack([col_major(spp_a), col_major(spp_b)], axis=-1)
    mrp_o = col_major(mrp)
    cup = jnp.concatenate([
        jnp.stack([rl_slot, u1, u2], axis=-1),                 # [B,G,W,3]
        jnp.stack([col_major(cup_a), col_major(cup_b)],
                  axis=-1).reshape(B, G, W, 8),
    ], axis=-1)                                                # [B,G,W,11]
    return spp, mrp_o, cup


def decision_slots(mags, signs, band_class, valid, max_planes: int):
    """Dense decision slots for a batch of code-blocks.

    mags/signs: [B, H, W] int32 (H a multiple of 4); band_class: [B] int32
    (0=LL/LH, 1=HL, 2=HH); valid: [B, H, W] bool (True inside the block's
    true extent); max_planes: static bound on bitplanes (band Mb).

    Returns uint8 [B, T] slots in exact serial emission order."""
    B, H, W = mags.shape
    maxmag = jnp.max(jnp.where(valid, mags, 0), axis=(1, 2), keepdims=True)
    yy = jax.lax.broadcasted_iota(jnp.int32, (1, H, 1), 1)
    r = (yy & 3) * jnp.ones((1, 1, W), jnp.int32)
    bc3 = band_class[:, None, None]
    out = []
    for p in range(max_planes - 1, -1, -1):
        live = (maxmag >> p) > 0
        spp, mrp, cup = _plane_slots(mags, signs, valid, bc3, r, p, live)
        out.append(jnp.concatenate(
            [spp.reshape(B, -1), mrp.reshape(B, -1), cup.reshape(B, -1)],
            axis=1))
    return jnp.concatenate(out, axis=1)


def compact_host(slots: np.ndarray) -> list:
    """Host-side reference compaction: per block, the ordered (ctx, bit)
    decision list (drops EMPTY slots)."""
    out = []
    for row in np.asarray(slots):
        sel = row[row != EMPTY]
        out.append([(int(v & 0x1F), int(v >> 5)) for v in sel])
    return out


def numbps_of(mags: np.ndarray, valid: np.ndarray) -> np.ndarray:
    m = np.where(valid, mags, 0).reshape(mags.shape[0], -1).max(axis=1)
    return np.asarray([int(x).bit_length() for x in m], np.int32)
