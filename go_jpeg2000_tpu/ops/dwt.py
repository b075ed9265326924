"""Discrete wavelet transform (ISO/IEC 15444-1 Annex F) as vectorized jnp ops.

Implements the 5/3 reversible (integer) and 9/7 irreversible (float) lifting
DWT, 1-D/2-D/multi-level, with full support for arbitrary subband coordinate
parity (tile origins need not be even — the reference only supports
even-origin signals, dwt.go:73-262; this implementation follows the general
Annex F formulation with whole-sample symmetric extension).

Filter math parity with the reference (/root/reference/internal/dwt/dwt.go):
  5/3:  H[2n+1] -= floor((X[2n] + X[2n+2]) / 2)
        L[2n]   += floor((H[2n-1] + H[2n+1] + 2) / 4)
  9/7:  four lifting steps (alpha, beta, gamma, delta) + K scaling.

Everything here is shape-static and jit-friendly; the lifting steps are
masked element-wise updates the XLA fuser turns into a handful of
elementwise kernels per level.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp

# 9/7 lifting constants (Table F.4)
ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001

REV53 = "53"
IRR97 = "97"


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------- 1-D core

def _reflect_pad(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Whole-sample symmetric extension by one sample each side (F.3.7)."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (1, 1)
    return jnp.pad(x, pad, mode="reflect")


def _parity_mask(n: int, start_parity: int, want_odd: bool,
                 shape_ndim: int, axis: int) -> jnp.ndarray:
    coords = jax.lax.broadcasted_iota(jnp.int32, (n,), 0) + start_parity
    mask = (coords % 2 == 1) if want_odd else (coords % 2 == 0)
    shape = [1] * shape_ndim
    shape[axis] = n
    return mask.reshape(shape)


def _lift(x: jnp.ndarray, axis: int, start_parity: int, want_odd: bool, f):
    """x[u] = f(x[u], x[u-1], x[u+1]) for samples of the requested parity,
    with symmetric extension at the interval boundaries."""
    n = x.shape[axis]
    xp = _reflect_pad(x, axis)
    left = jax.lax.slice_in_dim(xp, 0, n, axis=axis)
    right = jax.lax.slice_in_dim(xp, 2, n + 2, axis=axis)
    upd = f(x, left, right)
    mask = _parity_mask(n, start_parity, want_odd, x.ndim, axis)
    return jnp.where(mask, upd, x)


def _forward_1d_53(x: jnp.ndarray, axis: int, parity: int) -> jnp.ndarray:
    """In-place-interleaved forward 5/3 along `axis`; `parity` is the
    absolute coordinate parity of the first sample (0=even)."""
    if x.shape[axis] == 1:
        # F.3.7: single-sample signal; odd-origin high-pass doubles.
        return x * 2 if parity == 1 else x
    x = _lift(x, axis, parity, True, lambda c, l, r: c - ((l + r) >> 1))
    x = _lift(x, axis, parity, False, lambda c, l, r: c + ((l + r + 2) >> 2))
    return x


def _inverse_1d_53(x: jnp.ndarray, axis: int, parity: int) -> jnp.ndarray:
    if x.shape[axis] == 1:
        return x >> 1 if parity == 1 else x
    x = _lift(x, axis, parity, False, lambda c, l, r: c - ((l + r + 2) >> 2))
    x = _lift(x, axis, parity, True, lambda c, l, r: c + ((l + r) >> 1))
    return x


def _scale_by_parity(x: jnp.ndarray, axis: int, parity: int,
                     even_scale: float, odd_scale: float) -> jnp.ndarray:
    n = x.shape[axis]
    odd = _parity_mask(n, parity, True, x.ndim, axis)
    return jnp.where(odd, x * odd_scale, x * even_scale)


def _forward_1d_97(x: jnp.ndarray, axis: int, parity: int) -> jnp.ndarray:
    if x.shape[axis] == 1:
        return x
    x = _lift(x, axis, parity, True, lambda c, l, r: c + ALPHA * (l + r))
    x = _lift(x, axis, parity, False, lambda c, l, r: c + BETA * (l + r))
    x = _lift(x, axis, parity, True, lambda c, l, r: c + GAMMA * (l + r))
    x = _lift(x, axis, parity, False, lambda c, l, r: c + DELTA * (l + r))
    return _scale_by_parity(x, axis, parity, 1.0 / K, K)


def _inverse_1d_97(x: jnp.ndarray, axis: int, parity: int) -> jnp.ndarray:
    if x.shape[axis] == 1:
        return x
    x = _scale_by_parity(x, axis, parity, K, 1.0 / K)
    x = _lift(x, axis, parity, False, lambda c, l, r: c - DELTA * (l + r))
    x = _lift(x, axis, parity, True, lambda c, l, r: c - GAMMA * (l + r))
    x = _lift(x, axis, parity, False, lambda c, l, r: c - BETA * (l + r))
    x = _lift(x, axis, parity, True, lambda c, l, r: c - ALPHA * (l + r))
    return x


def _deinterleave(x: jnp.ndarray, axis: int, parity: int
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split an interleaved signal into (low, high) by absolute parity."""
    even = jax.lax.slice_in_dim(x, 0, x.shape[axis], stride=2, axis=axis)
    odd = jax.lax.slice_in_dim(x, 1, x.shape[axis], stride=2, axis=axis)
    return (even, odd) if parity == 0 else (odd, even)


def _interleave(low: jnp.ndarray, high: jnp.ndarray, axis: int, parity: int
                ) -> jnp.ndarray:
    n = low.shape[axis] + high.shape[axis]
    first, second = (low, high) if parity == 0 else (high, low)
    shape = list(low.shape)
    shape[axis] = n
    out = jnp.zeros(shape, dtype=low.dtype)
    idx_f = [slice(None)] * out.ndim
    idx_f[axis] = slice(0, n, 2)
    idx_s = [slice(None)] * out.ndim
    idx_s[axis] = slice(1, n, 2)
    out = out.at[tuple(idx_f)].set(first)
    out = out.at[tuple(idx_s)].set(second)
    return out


def forward_1d(x: jnp.ndarray, kind: str = REV53, axis: int = -1,
               parity: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward 1-D DWT along `axis`; returns (low, high) subbands."""
    axis = axis % x.ndim
    fn = _forward_1d_53 if kind == REV53 else _forward_1d_97
    return _deinterleave(fn(x, axis, parity), axis, parity)


def inverse_1d(low: jnp.ndarray, high: jnp.ndarray, kind: str = REV53,
               axis: int = -1, parity: int = 0) -> jnp.ndarray:
    axis = axis % low.ndim
    x = _interleave(low, high, axis, parity)
    fn = _inverse_1d_53 if kind == REV53 else _inverse_1d_97
    return fn(x, axis, parity)


# ---------------------------------------------------------------- 2-D level

def forward_2d(a: jnp.ndarray, kind: str = REV53, u0: int = 0, v0: int = 0
               ) -> Dict[str, jnp.ndarray]:
    """One 2-D decomposition of `a` (shape [..., H, W], origin (v0, u0)).

    Column (vertical) transform first, then rows — matching the Annex F
    2D_SD ordering whose inverse (2D_SR) interleaves rows first.
    Returns dict with LL/HL/LH/HH.
    """
    fn = _forward_1d_53 if kind == REV53 else _forward_1d_97
    a = fn(a, a.ndim - 2, v0 & 1)           # vertical
    a = fn(a, a.ndim - 1, u0 & 1)           # horizontal
    lo_y, hi_y = _deinterleave(a, a.ndim - 2, v0 & 1)
    ll, hl = _deinterleave(lo_y, lo_y.ndim - 1, u0 & 1)
    lh, hh = _deinterleave(hi_y, hi_y.ndim - 1, u0 & 1)
    return {"LL": ll, "HL": hl, "LH": lh, "HH": hh}


def inverse_2d(bands: Dict[str, jnp.ndarray], kind: str = REV53,
               u0: int = 0, v0: int = 0) -> jnp.ndarray:
    ll, hl, lh, hh = bands["LL"], bands["HL"], bands["LH"], bands["HH"]
    lo_y = _interleave(ll, hl, ll.ndim - 1, u0 & 1)
    hi_y = _interleave(lh, hh, lh.ndim - 1, u0 & 1)
    a = _interleave(lo_y, hi_y, lo_y.ndim - 2, v0 & 1)
    fn = _inverse_1d_53 if kind == REV53 else _inverse_1d_97
    a = fn(a, a.ndim - 1, u0 & 1)           # horizontal first (2D_SR)
    a = fn(a, a.ndim - 2, v0 & 1)           # then vertical
    return a


# ------------------------------------------------------------- multi-level

def decompose(a: jnp.ndarray, levels: int, kind: str = REV53,
              u0: int = 0, v0: int = 0) -> List[Dict[str, jnp.ndarray]]:
    """Multi-level decomposition.

    Returns a list of `levels` dicts {HL, LH, HH} ordered from decomposition
    level 1 (finest, first applied) to `levels` (coarsest), with the final
    LL stored in the last dict as well.  Empty-size levels produce
    zero-extent arrays (legal when a dimension collapses).
    """
    out: List[Dict[str, jnp.ndarray]] = []
    cur = a
    cu, cv = u0, v0
    for lev in range(1, levels + 1):
        bands = forward_2d(cur, kind, cu, cv)
        entry = {"HL": bands["HL"], "LH": bands["LH"], "HH": bands["HH"]}
        cur = bands["LL"]
        cu, cv = ceil_div(cu, 2), ceil_div(cv, 2)
        if lev == levels:
            entry["LL"] = cur
        out.append(entry)
    if levels == 0:
        out.append({"LL": a})
    return out


def reconstruct(pyramid: List[Dict[str, jnp.ndarray]], kind: str = REV53,
                u0: int = 0, v0: int = 0) -> jnp.ndarray:
    """Inverse of :func:`decompose`."""
    levels = len(pyramid) if "HL" in pyramid[-1] else len(pyramid) - 1
    if levels == 0:
        return pyramid[0]["LL"]
    # origin of each level's input
    origins = [(u0, v0)]
    for _ in range(levels):
        origins.append((ceil_div(origins[-1][0], 2), ceil_div(origins[-1][1], 2)))
    cur = pyramid[levels - 1]["LL"]
    for lev in range(levels, 0, -1):
        cu, cv = origins[lev - 1]
        entry = pyramid[lev - 1]
        cur = inverse_2d({"LL": cur, "HL": entry["HL"],
                          "LH": entry["LH"], "HH": entry["HH"]},
                         kind, cu, cv)
    return cur


def subband_shapes(h: int, w: int, levels: int, u0: int = 0, v0: int = 0
                   ) -> List[Dict[str, Tuple[int, int]]]:
    """Static band shapes for decompose() without running it."""
    out = []
    cu0, cv0, cu1, cv1 = u0, v0, u0 + w, v0 + h
    for lev in range(1, levels + 1):
        nlx = ceil_div(cu1, 2) - ceil_div(cu0, 2)
        nhx = cu1 // 2 - cu0 // 2
        nly = ceil_div(cv1, 2) - ceil_div(cv0, 2)
        nhy = cv1 // 2 - cv0 // 2
        entry = {"HL": (nly, nhx), "LH": (nhy, nlx), "HH": (nhy, nhx)}
        cu0, cv0, cu1, cv1 = (ceil_div(cu0, 2), ceil_div(cv0, 2),
                              ceil_div(cu1, 2), ceil_div(cv1, 2))
        if lev == levels:
            entry["LL"] = (nly, nlx)
        out.append(entry)
    if levels == 0:
        out.append({"LL": (h, w)})
    return out
