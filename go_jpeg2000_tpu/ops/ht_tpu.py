"""HTJ2K cleanup-pass encoder as a data-parallel device (jnp) kernel.

The key insight making HT vector-friendly (SURVEY.md §7: HT is the most
accelerator-friendly coder — prioritize it as the throughput path): in the
*encoder*
every quantity the T.814 cleanup pass codes — quad significance rho, context
c_q (from the causal neighborhood), kappa/U/u_off, the CxtVLC codeword, the
EMB e_1/e_k bits and the MagSgn magnitude fields — is a pure function of the
coefficient array.  Nothing depends on the evolving bitstream, so the whole
block (and a batch of thousands of blocks) evaluates as fused element-wise
ops.  Only two byte-oriented tails remain, both linear in output size
and handled off-kernel: the adaptive MEL run-length state machine and the
stuffing-aware byte packing (native serializer in native/j2k_native.cpp,
Python twin below for differential testing).

Contrast with the reference, whose block coder is scalar-sequential per
sample (/root/reference/internal/entropy/ht.go:942-1044) and parallel only
across goroutines (encoder.go:690-742).

Bitstream layout produced (identical to ops/ht.py `encode_cleanup`, which is
OpenJPEG-validated):  MagSgn (fwd) | MEL | VLC (bwd) | 12-bit SCUP trailer.

Device outputs per code-block:
  - unstuffed MagSgn bit-stream packed into uint32 words + bit count
  - unstuffed VLC bit-stream (decode order) + bit count
  - MEL event bit-string (1 bit per event, in order) + event count
  - numbps, u_max
The serializer re-reads these streams sequentially and applies the byte
stuffing rules; it never re-derives any coding decision.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import ht as ht_ref

# Algorithm switches for the two compaction steps (timed per stage by
# tools/profile_kernel_stages.py; CPU tests assert both agree; not yet
# measured on a GPU):
#   PACK_PLACE_IMPL: dense word placement inside _pack_bits —
#                    "sort" (lax.sort_key_val) | "search" (binary search
#                    via flat gathers)
#   COMPACT_IMPL:    pool compaction — "sort" (global sort_key_val) |
#                    "gather" (row lookup via searchsorted + one flat
#                    gather)
PACK_PLACE_IMPL = "sort"
COMPACT_IMPL = "sort"
# "paired" pre-combines adjacent fields elementwise (2-limb merge), cutting
# the pack's item count from 2F to 1.5F (see _pack_bits_paired).  A bitonic
# sort pads its width to the next power of two, so 6144 and 8192 items cost
# the same 8192-wide network — item-count reductions only pay off when they
# cross a power-of-two boundary (they cannot here: items >= F+F/G > 4096
# for any group size G).  "base" stays the default.
PACK_IMPL = "base"


# ---------------------------------------------------------------------------
# Direct-indexed encoder VLC table.
#
# ops/ht.py selects, per (ctx, rho, u_off), the candidate (e1, ek, cwd, len)
# maximizing (popcount(ek), -len) subject to EMB validity against the actual
# MSB pattern at bitplane U-1.  That choice is a pure function of
# (initial, ctx, rho, u_off, msb4) — flatten it into one gather table.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _direct_enc_table() -> np.ndarray:
    tbl = np.zeros(2 * 8 * 16 * 2 * 16, dtype=np.int32)
    for init, src in ((0, ht_ref.ENC_TBL0), (1, ht_ref.ENC_TBL1)):
        for (ctx, rho, uoff), cands in src.items():
            for msb in range(16):
                best = None
                for (e1, ek, cwd, ln) in cands:
                    ok = True
                    for i in range(4):
                        if (ek >> i) & 1:
                            if not ((rho >> i) & 1):
                                ok = False
                                break
                            if ((e1 >> i) & 1) != ((msb >> i) & 1):
                                ok = False
                                break
                        else:
                            if (e1 >> i) & 1:
                                ok = False
                                break
                    if not ok:
                        continue
                    score = bin(ek).count("1")
                    key = (score, -ln)
                    if best is None or key > best[0]:
                        best = (key, e1, ek, cwd, ln)
                if best is None:
                    continue
                _, e1, ek, cwd, ln = best
                idx = ((((init * 8 + ctx) * 16 + rho) * 2 + uoff) * 16 + msb)
                tbl[idx] = e1 | (ek << 4) | (cwd << 8) | (ln << 16)
    return tbl


def _bitlen(v):
    """Integer bit length of a non-negative int32/uint32 array: one clz
    instead of the 5-round shift/where ladder (bitlen(0) = 0 falls out of
    clz(0) = 32)."""
    return 32 - jax.lax.clz(v.astype(jnp.uint32)).astype(jnp.int32)


def _uvlc_fields(t):
    """Vectorized UVLC prefix/suffix for biased value t >= 1 (ops/ht.py
    `_uvlc_encode_value`).  Returns (prefix, prefix_len, suffix, suffix_len)."""
    t = t.astype(jnp.int32)
    p = jnp.where(t == 1, 1, jnp.where(t == 2, 2, jnp.where(t <= 4, 4, 0)))
    pl = jnp.where(t == 1, 1, jnp.where(t == 2, 2, 3))
    s = jnp.where(t <= 2, 0, jnp.where(t <= 4, t - 3, t - 5))
    sl = jnp.where(t <= 2, 0, jnp.where(t <= 4, 1, 5))
    return p, pl, s, sl


def _pack_bits(vals, lens, n_words: int):
    """Pack per-field LSB-first bit strings into uint32 words, per block.

    vals/lens: [Nb, F] (vals already masked to their bit length).  Fields
    with len 0 contribute nothing.  Returns (words [Nb, n_words] uint32,
    total_bits [Nb]).

    Scatter-free: scatters with colliding indices serialize, so word
    assembly runs as a segmented OR-scan over the (monotone) word-index key
    sequence — log2(2F) shift+where steps, all elementwise — followed by
    one batched
    searchsorted gather per output word.
    """
    nb, f = vals.shape
    vals = vals.astype(jnp.uint32)
    lens = lens.astype(jnp.int32)
    off = jnp.cumsum(lens, axis=1) - lens
    total = off[:, -1] + lens[:, -1] if f else jnp.zeros((nb,), jnp.int32)
    widx = off >> 5
    bit = (off & 31).astype(jnp.uint32)
    present = lens > 0
    lo = jnp.where(present, vals << bit, 0)
    hi = jnp.where(present & (bit > 0),
                   vals >> ((32 - bit) & 31), 0)
    # item 2i   = (start word of field i, lo)
    # item 2i+1 = (end word of field i,   hi)   [end==start when no spill]
    end = (off + jnp.maximum(lens, 1) - 1) >> 5
    keys = jnp.stack([widx, end], axis=-1).reshape(nb, 2 * f)
    items = jnp.stack([lo, hi], axis=-1).reshape(nb, 2 * f)
    items = _segmented_or_scan(keys, items)
    # word j = OR of its items = the segment-end item with key == j.  The
    # bit stream is gapless, so segment ends in order have keys exactly
    # 0,1,2,... — dense placement is therefore a COMPACTION of segment-end
    # items.  Two formulations, selected by PACK_PLACE_IMPL:
    #   "sort":   one lax.sort_key_val per row (the default)
    #   "search": vectorized binary search for the j-th segment end (log2 F
    #             rounds of FLAT gathers) + one flat item gather
    is_end = jnp.concatenate(
        [keys[:, 1:] != keys[:, :-1],
         jnp.ones((nb, 1), bool)], axis=1)
    if PACK_PLACE_IMPL == "search":
        # kk_i = key of the last end at or before i; it steps up to value j
        # exactly AT the end whose key is j, so that end's index is the
        # LOWER BOUND (first i with kk_i >= j).  Vectorized binary search:
        # log2(2F) rounds of flat gathers.
        kk = jnp.where(is_end, keys, jnp.int32(-1))
        kk = jax.lax.cummax(kk, axis=1)      # monotone search keys
        flat_k = kk.reshape(-1)
        jq = jax.lax.broadcasted_iota(jnp.int32, (nb, n_words), 1)
        lo = jnp.zeros((nb, n_words), jnp.int32)
        hi = jnp.full((nb, n_words), 2 * f - 1, jnp.int32)
        base = (jax.lax.broadcasted_iota(jnp.int32, (nb, n_words), 0)
                * (2 * f))
        steps = max(1, (2 * f - 1).bit_length())
        for _ in range(steps):
            mid = (lo + hi) >> 1
            km = jnp.take(flat_k, (base + mid).reshape(-1),
                          mode="clip").reshape(nb, n_words)
            ge = km >= jq
            hi = jnp.where(ge, mid, hi)
            lo = jnp.where(ge, lo, mid + 1)
        p = lo
        km = jnp.take(flat_k, (base + p).reshape(-1),
                      mode="clip").reshape(nb, n_words)
        ie = jnp.take(is_end.reshape(-1), (base + p).reshape(-1),
                      mode="clip").reshape(nb, n_words)
        vals_g = jnp.take(items.reshape(-1), (base + p).reshape(-1),
                          mode="clip").reshape(nb, n_words)
        words = jnp.where((km == jq) & ie, vals_g, 0)
    else:
        sort_k = jnp.where(is_end, keys, jnp.int32(2**30))
        _, sv = jax.lax.sort_key_val(sort_k, items, dimension=1)
        take = min(n_words, 2 * f)
        words = sv[:, :take]
        if take < n_words:
            words = jnp.pad(words, ((0, 0), (0, n_words - take)))
    nw_used = (total[:, None] + 31) >> 5
    words = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, (1, n_words), 1) < nw_used,
        words, 0)
    return words, total


def _pack_bits_paired(vals, lens, n_words: int):
    """_pack_bits with an elementwise PRE-COMBINE of adjacent field pairs.

    Two fields (<=31 bits each) merge into one <=62-bit 2-limb field with
    pure u32 arithmetic, halving the field count; each merged field spans
    <=3 words, so the scan/sort carries 3 items per pair = 1.5F instead of
    2F — the sort is the pack's bandwidth-bound cost (a bitonic network
    over [Nb, 2F]), so item count is the lever.  Bit-exact vs _pack_bits
    (differential-tested).
    """
    nb, f = vals.shape
    if f % 2:
        vals = jnp.pad(vals, ((0, 0), (0, 1)))
        lens = jnp.pad(lens, ((0, 0), (0, 1)))
        f += 1
    v = vals.astype(jnp.uint32).reshape(nb, f // 2, 2)
    l = lens.astype(jnp.int32).reshape(nb, f // 2, 2)
    # callers may leave junk above a field's bit length (e.g. a VLC
    # codeword with cwd_len forced to 0 for uncoded quads) — the base impl
    # masks via `present`, here the merge must mask per limb
    v = v & ((jnp.uint32(1) << jnp.minimum(l, 31).astype(jnp.uint32))
             - jnp.uint32(1))
    v = jnp.where(l > 0, v, jnp.uint32(0))
    l0 = l[..., 0].astype(jnp.uint32)
    lo = v[..., 0] | jnp.where(l0 < 32, v[..., 1] << l0, 0)
    hi = jnp.where(l0 > 0, v[..., 1] >> ((32 - l0) & 31), 0)
    hi = jnp.where(l0 == 0, jnp.uint32(0), hi)
    plen = l[..., 0] + l[..., 1]                  # [Nb, F/2] <= 62

    off = jnp.cumsum(plen, axis=1) - plen
    total = (off[:, -1] + plen[:, -1]).astype(jnp.int32)
    s = off >> 5
    e = (off + jnp.maximum(plen, 1) - 1) >> 5
    bit = (off & 31).astype(jnp.uint32)
    present = plen > 0
    c0 = jnp.where(present, lo << bit, 0)
    c1 = jnp.where(present & (bit > 0), lo >> ((32 - bit) & 31), 0) \
        | jnp.where(present, jnp.where(bit < 32, hi << bit, 0), 0)
    c2 = jnp.where(present & (bit > 0), hi >> ((32 - bit) & 31), 0)
    # clamp item keys to the field's end word so the global key sequence
    # stays monotone (span < 3 masks the clamped contributions to 0)
    k1 = jnp.minimum(s + 1, e)
    c1 = jnp.where(s + 1 <= e, c1, 0)
    c2 = jnp.where(s + 2 <= e, c2, 0)
    fp = f // 2
    keys = jnp.stack([s, k1, e], axis=-1).reshape(nb, 3 * fp)
    items = jnp.stack([c0, c1, c2], axis=-1).reshape(nb, 3 * fp)
    items = _segmented_or_scan(keys, items)
    is_end = jnp.concatenate(
        [keys[:, 1:] != keys[:, :-1],
         jnp.ones((nb, 1), bool)], axis=1)
    sort_k = jnp.where(is_end, keys, jnp.int32(2**30))
    _, sv = jax.lax.sort_key_val(sort_k, items, dimension=1)
    take = min(n_words, 3 * fp)
    words = sv[:, :take]
    if take < n_words:
        words = jnp.pad(words, ((0, 0), (0, n_words - take)))
    nw_used = (total[:, None] + 31) >> 5
    words = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, (1, n_words), 1) < nw_used,
        words, 0)
    return words, total


def _segmented_or_scan(keys, items):
    """Inclusive segmented OR-scan along axis 1: items are OR-combined with
    all earlier items sharing the same key (keys monotone non-decreasing).
    log2(F) doubling steps of shift+where, no scatter/gather."""
    nb, f = items.shape
    s = 1
    while s < f:
        pk = jnp.pad(keys[:, :-s], ((0, 0), (s, 0)), constant_values=-1)
        pv = jnp.pad(items[:, :-s], ((0, 0), (s, 0)))
        items = items | jnp.where(pk == keys, pv, 0)
        s <<= 1
    return items


def cleanup_fields(coeffs, hs, ws, max_mn: int):
    """Compute all HT cleanup coding fields for a batch of code-blocks.

    coeffs: int32 [Nb, H, W] with H, W even (zero-padded); hs/ws: true
    per-block dims.  max_mn: static bound on MagSgn field bits
    (>= Mb + 2; magnitudes must fit 30 bits).

    Returns dict of device arrays (see module docstring).
    """
    nb, h, w = coeffs.shape
    assert h % 2 == 0 and w % 2 == 0
    qh, qw = h // 2, w // 2
    qwp = qw + (qw & 1)            # pad quad columns to even (pair grid)
    pairs = qwp // 2

    hs = hs.astype(jnp.int32)[:, None, None]
    ws = ws.astype(jnp.int32)[:, None, None]
    yy = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 1)
    xx = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 2)
    valid = (yy < hs) & (xx < ws)

    c = coeffs.astype(jnp.int32)
    mags = jnp.where(valid, jnp.abs(c), 0)
    neg = (c < 0) & valid
    v = jnp.where(mags > 0,
                  ((mags - 1) << 1) | neg.astype(jnp.int32), 0)
    e = _bitlen(v)
    sg = (mags > 0)

    numbps = _bitlen(jnp.max(mags.reshape(nb, -1), axis=1))

    def quad(a, pad_val=0):
        q = jnp.stack([a[:, 0::2, 0::2], a[:, 1::2, 0::2],
                       a[:, 0::2, 1::2], a[:, 1::2, 1::2]], axis=-1)
        if qwp != qw:
            q = jnp.pad(q, ((0, 0), (0, 0), (0, qwp - qw), (0, 0)),
                        constant_values=pad_val)
        return q

    v4 = quad(v).astype(jnp.uint32)          # [Nb, qh, qwp, 4]
    e4 = quad(e)
    s4 = quad(sg.astype(jnp.int32))

    rho = (s4[..., 0] | (s4[..., 1] << 1)
           | (s4[..., 2] << 2) | (s4[..., 3] << 3))
    emax = jnp.max(e4, axis=-1)

    qy = jax.lax.broadcasted_iota(jnp.int32, (1, qh, qwp), 1)
    qx = jax.lax.broadcasted_iota(jnp.int32, (1, qh, qwp), 2)
    qh_b = (hs + 1) >> 1
    qw_b = (ws + 1) >> 1
    exists = (qx < qw_b) & (qy < qh_b)
    is_init = qy == 0

    # ---- line state from the stripe above (ops/ht.py `_update_ls`,
    # entry q <- n1 of quad q and n3 of quad q-1; T.814 pinned) ----
    sig_n1, sig_n3 = s4[..., 1], s4[..., 3]
    e_n1 = jnp.where(sig_n1 > 0, e4[..., 1], 0)
    e_n3 = jnp.where(sig_n3 > 0, e4[..., 3], 0)
    z3 = ((0, 0), (0, 0))
    ls_sig = (jnp.pad(sig_n1, z3 + ((0, 1),))
              | jnp.pad(sig_n3, z3 + ((1, 0),)))           # [Nb, qh, qwp+1]
    ls_e = jnp.maximum(jnp.pad(e_n1, z3 + ((0, 1),)),
                       jnp.pad(e_n3, z3 + ((1, 0),)))
    prev_sig = jnp.pad(ls_sig[:, :-1], ((0, 0), (1, 0), (0, 0)))
    prev_e = jnp.pad(ls_e[:, :-1], ((0, 0), (1, 0), (0, 0)))

    # ---- context (uniform over both quads of a pair) ----
    rho_w = jnp.pad(rho, z3 + ((1, 0),))[:, :, :-1]
    ctx_init = ((rho_w & 1) | (rho_w >> 1)) & 7
    w_bit = ((rho_w & 0xC) != 0).astype(jnp.int32)
    n_bit = prev_sig[:, :, :qwp]
    ne_bit = prev_sig[:, :, 1:qwp + 1]
    ctx_non = n_bit | (w_bit << 1) | (ne_bit << 2)
    ctx = jnp.where(is_init, ctx_init, ctx_non)

    # ---- kappa / U / u_off ----
    pc = ((rho & 1) + ((rho >> 1) & 1) + ((rho >> 2) & 1) + ((rho >> 3) & 1))
    gamma = pc > 1
    emax_n = jnp.maximum(prev_e[:, :, :qwp], prev_e[:, :, 1:qwp + 1])
    kappa = jnp.where(is_init, 1,
                      jnp.where(gamma, jnp.maximum(1, emax_n - 1), 1))
    coded = exists & ((ctx != 0) | (rho != 0))
    azc = exists & (ctx == 0)
    u = jnp.maximum(kappa, emax)
    u_off = ((u - kappa) > 0) & coded
    u_max = jnp.maximum(1, jnp.max(
        jnp.where(coded, u, 0).reshape(nb, -1), axis=1))

    # ---- VLC codeword lookup ----
    msb = jnp.zeros(rho.shape, jnp.int32)
    ushift = jnp.maximum(u - 1, 0).astype(jnp.uint32)
    for i in range(4):
        msb = msb | ((((v4[..., i] >> ushift) & 1).astype(jnp.int32)) << i)
    init_i = jnp.where(is_init, 0, 1) * jnp.ones(rho.shape, jnp.int32)
    idx = ((((init_i * 8 + ctx) * 16 + rho) * 2
            + u_off.astype(jnp.int32)) * 16 + msb)
    tbl = jnp.asarray(_direct_enc_table())
    entry = tbl[idx]
    cwd = (entry >> 8) & 0xFF
    cwd_len = jnp.where(coded, (entry >> 16) & 0xF, 0)
    ek = (entry >> 4) & 0xF

    # ---- MagSgn fields, in-quad order n0..n3 ----
    m_n = jnp.clip(u[..., None] - ((ek[..., None]
                                    >> jnp.arange(4, dtype=jnp.int32)) & 1),
                   0, 31)
    ms_len = jnp.where((s4 > 0) & coded[..., None], m_n, 0)
    ms_val = v4 & ((jnp.uint32(1) << ms_len.astype(jnp.uint32))
                   - jnp.uint32(1))

    # ---- per-pair u coding + MEL events ----
    def pair_view(a):
        return a.reshape(nb, qh, pairs, 2)

    u_p = pair_view(u)
    kappa_p = pair_view(kappa)
    uoff_p = pair_view(u_off.astype(jnp.int32))
    init_row = (jax.lax.broadcasted_iota(jnp.int32, (1, qh, pairs), 1) == 0)

    mode = uoff_p[..., 0] + 2 * uoff_p[..., 1]
    u0i = u_p[..., 0] - 1                       # initial-stripe biased u
    u1i = u_p[..., 1] - 1
    uq0 = u_p[..., 0] - kappa_p[..., 0]
    uq1 = u_p[..., 1] - kappa_p[..., 1]
    big = (u0i > 2) & (u1i > 2)

    # candidate encodings (computed unconditionally, selected by where)
    pI0, plI0, sI0, slI0 = _uvlc_fields(jnp.maximum(u0i, 1))
    pI1, plI1, sI1, slI1 = _uvlc_fields(jnp.maximum(u1i, 1))
    pB0, plB0, sB0, slB0 = _uvlc_fields(jnp.maximum(u0i - 2, 1))
    pB1, plB1, sB1, slB1 = _uvlc_fields(jnp.maximum(u1i - 2, 1))
    pN0, plN0, sN0, slN0 = _uvlc_fields(jnp.maximum(uq0, 1))
    pN1, plN1, sN1, slN1 = _uvlc_fields(jnp.maximum(uq1, 1))

    zero = jnp.zeros(mode.shape, jnp.int32)

    def sel(c, a, b):
        return jnp.where(c, a, b)

    m3 = mode == 3
    m1 = mode == 1
    m2 = mode == 2
    # initial-stripe slots
    i_s2v = sel(m3, sel(big, pB0, pI0), sel(m1, pI0, sel(m2, pI1, zero)))
    i_s2l = sel(m3, sel(big, plB0, plI0), sel(m1, plI0, sel(m2, plI1, zero)))
    i_s3v = sel(m3, sel(big, pB1, sel(u0i > 2, u1i - 1, pI1)),
                sel(m1, sI0, sel(m2, sI1, zero)))
    i_s3l = sel(m3, sel(big, plB1, sel(u0i > 2, 1, plI1)),
                sel(m1, slI0, sel(m2, slI1, zero)))
    i_s4v = sel(m3, sel(big, sB0, sI0), zero)
    i_s4l = sel(m3, sel(big, slB0, slI0), zero)
    i_s5v = sel(m3, sel(big, sB1, sel(u0i > 2, zero, sI1)), zero)
    i_s5l = sel(m3, sel(big, slB1, sel(u0i > 2, zero, slI1)), zero)
    # non-initial slots
    n_s2v = sel(m3, pN0, sel(m1, pN0, sel(m2, pN1, zero)))
    n_s2l = sel(m3, plN0, sel(m1, plN0, sel(m2, plN1, zero)))
    n_s3v = sel(m3, pN1, sel(m1, sN0, sel(m2, sN1, zero)))
    n_s3l = sel(m3, plN1, sel(m1, slN0, sel(m2, slN1, zero)))
    n_s4v = sel(m3, sN0, zero)
    n_s4l = sel(m3, slN0, zero)
    n_s5v = sel(m3, sN1, zero)
    n_s5l = sel(m3, slN1, zero)

    s2v = sel(init_row, i_s2v, n_s2v)
    s2l = sel(init_row, i_s2l, n_s2l)
    s3v = sel(init_row, i_s3v, n_s3v)
    s3l = sel(init_row, i_s3l, n_s3l)
    s4v = sel(init_row, i_s4v, n_s4v)
    s4l = sel(init_row, i_s4l, n_s4l)
    s5v = sel(init_row, i_s5v, n_s5v)
    s5l = sel(init_row, i_s5l, n_s5l)

    cwd_p = pair_view(cwd)
    cwdl_p = pair_view(cwd_len)
    vlc_vals = jnp.stack([cwd_p[..., 0], cwd_p[..., 1],
                          s2v, s3v, s4v, s5v], axis=-1)
    vlc_lens = jnp.stack([cwdl_p[..., 0], cwdl_p[..., 1],
                          s2l, s3l, s4l, s5l], axis=-1)

    azc_p = pair_view(azc.astype(jnp.int32))
    rho_p = pair_view(rho)
    mel_vals = jnp.stack([(rho_p[..., 0] != 0).astype(jnp.int32),
                          (rho_p[..., 1] != 0).astype(jnp.int32),
                          big.astype(jnp.int32)], axis=-1)
    mel_lens = jnp.stack([azc_p[..., 0], azc_p[..., 1],
                          (init_row & m3).astype(jnp.int32)], axis=-1)

    # ---- pack the three streams ----
    mw = (h * w * max_mn + 31) // 32
    vw = (qh * pairs * 32 + 31) // 32
    ew = (qh * pairs * 3 + 31) // 32
    pack = _pack_bits_paired if PACK_IMPL == "paired" else _pack_bits
    ms_words, ms_bits = pack(
        ms_val.reshape(nb, qh, pairs, 2, 4).reshape(nb, -1),
        ms_len.reshape(nb, qh, pairs, 2, 4).reshape(nb, -1), mw)
    vlc_words, vlc_bits = pack(
        vlc_vals.reshape(nb, -1).astype(jnp.uint32),
        vlc_lens.reshape(nb, -1), vw)
    mel_words, mel_bits = pack(
        mel_vals.reshape(nb, -1).astype(jnp.uint32),
        mel_lens.reshape(nb, -1), ew)

    dist = jnp.sum((mags.astype(jnp.float32) ** 2).reshape(nb, -1), axis=1)
    return {
        "ms_words": ms_words, "ms_bits": ms_bits,
        "vlc_words": vlc_words, "vlc_bits": vlc_bits,
        "mel_words": mel_words, "mel_bits": mel_bits,
        "numbps": numbps, "u_max": u_max, "dist": dist,
    }


def compact_pool(words, bits, cap_words: int):
    """Concatenate per-block packed streams into one dense word pool.

    words [Nb, W] uint32, bits [Nb] — each block's stream occupies
    ceil(bits/32) leading words.  Returns (pool [cap_words] uint32,
    off [Nb] word offsets, nw [Nb] word counts).  Blocks past the static
    capacity are dropped (caller must check sum(nw) <= cap_words on host
    and fall back if exceeded).
    """
    nb, w = words.shape
    nw = (bits.astype(jnp.int32) + 31) >> 5
    ends = jnp.cumsum(nw)
    off = ends - nw
    total = ends[-1] if nb else jnp.int32(0)
    if COMPACT_IMPL == "gather":
        # ragged row-prefix concat: pool[k] = words[row, k - off[row]] with
        # row = searchsorted(ends, k, 'right') — one searchsorted over the
        # [nb] ends + one flat gather from the [nb*w] word matrix
        k = jnp.arange(cap_words, dtype=jnp.int32)
        row = jnp.searchsorted(ends, k, side="right", method="scan_unrolled")
        row = jnp.clip(row, 0, nb - 1).astype(jnp.int32)
        idx = row * w + (k - jnp.take(off, row, mode="clip"))
        pool = jnp.take(words.reshape(-1),
                        jnp.clip(idx, 0, nb * w - 1), mode="clip")
        pool = jnp.where(k < total, pool, jnp.uint32(0))
        return pool, off, nw
    # compaction-via-sort (the r3/r4 default):
    # live word (b, j<nw_b) gets global key off_b + j, dead words sort last
    local = jax.lax.broadcasted_iota(jnp.int32, (nb, w), 1)
    key = jnp.where(local < nw[:, None], off[:, None] + local,
                    jnp.int32(2**30))
    _, sv = jax.lax.sort_key_val(key.reshape(-1), words.reshape(-1))
    take = min(cap_words, nb * w)
    pool = sv[:take]
    if take < cap_words:
        pool = jnp.pad(pool, (0, cap_words - take))
    pool = jnp.where(jnp.arange(cap_words, dtype=jnp.int32) < total,
                     pool, jnp.uint32(0))
    return pool, off, nw


def cleanup_fields_compact(coeffs, hs, ws, max_mn: int,
                           cap_ms: int, cap_vlc: int, cap_mel: int):
    """cleanup_fields + device-side compaction of the three streams into ONE
    dense uint32 array [6*Nb + cap_ms + cap_vlc + cap_mel]: 6 meta rows
    (ms_bits, vlc_bits, mel_bits, numbps, u_max, dist-bitcast) followed by
    the three word pools.  A single array means a single program output
    that the host slices and fetches.  Per-block word offsets are recomputed
    on host
    from the bit counts (same cumsum).
    """
    f = cleanup_fields(coeffs, hs, ws, max_mn)
    ms_pool, _, _ = compact_pool(f["ms_words"], f["ms_bits"], cap_ms)
    vlc_pool, _, _ = compact_pool(f["vlc_words"], f["vlc_bits"], cap_vlc)
    mel_pool, _, _ = compact_pool(f["mel_words"], f["mel_bits"], cap_mel)
    meta = jnp.stack([f["ms_bits"], f["vlc_bits"], f["mel_bits"],
                      f["numbps"], f["u_max"],
                      jax.lax.bitcast_convert_type(f["dist"], jnp.int32)])
    return jnp.concatenate([meta.reshape(-1).astype(jnp.uint32),
                            ms_pool, vlc_pool, mel_pool])


def pool_offsets(bits: np.ndarray, base: int, cap: int):
    """Host twin of compact_pool's placement: word offsets + counts.
    Returns (off int64, nw int64, overflowed bool)."""
    nw = ((bits.astype(np.int64) + 31) >> 5)
    off = np.cumsum(nw) - nw
    return off + base, nw, bool(off[-1] + nw[-1] > cap) if len(nw) else False


# ---------------------------------------------------------------------------
# Host serializer (Python twin of the native one): streams -> segment bytes.
# ---------------------------------------------------------------------------

class _BitSrc:
    def __init__(self, words: np.ndarray, nbits: int):
        self.words = words
        self.nbits = int(nbits)
        self.pos = 0

    def take(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos += n
        w = p >> 5
        b = p & 31
        lo = int(self.words[w]) >> b
        if b + n > 32 and w + 1 < len(self.words):
            lo |= int(self.words[w + 1]) << (32 - b)
        return lo & ((1 << n) - 1)

    @property
    def remaining(self) -> int:
        return self.nbits - self.pos


def serialize_block(ms_words, ms_bits, vlc_words, vlc_bits,
                    mel_words, mel_bits, numbps) -> Tuple[bytes, int]:
    """Assemble one cleanup segment from the kernel's packed streams.

    Returns (segment_bytes, numbps).  Bit-identical to
    ops/ht.py `encode_cleanup` (differentially tested)."""
    if numbps == 0:
        return b"", 0

    # MagSgn: LSB-first bytes, 7-bit cap after 0xFF
    src = _BitSrc(ms_words, ms_bits)
    magsgn = bytearray()
    last_ff = False
    while src.remaining > 0:
        cap = 7 if last_ff else 8
        take = min(cap, src.remaining)
        b = src.take(take)
        magsgn.append(b)
        last_ff = (b == 0xFF)

    # MEL: replay events through the adaptive coder
    mel = ht_ref.MELWriter()
    esrc = _BitSrc(mel_words, mel_bits)
    for _ in range(int(mel_bits)):
        mel.encode(esrc.take(1))
    mel.terminate()
    mel_bytes, mel_acc, mel_nb = mel.byte_stream()
    if mel_nb:
        cap = 7 if (mel_bytes and mel_bytes[-1] == 0xFF) else 8
        mel_bytes.append((mel_acc << (cap - mel_nb)) & 0xFF)
    if mel_bytes and mel_bytes[-1] == 0xFF:
        mel_bytes.append(0)

    # VLC: nibble + backward stuffed packing
    vsrc = _BitSrc(vlc_words, vlc_bits)
    nib = vsrc.take(min(3, vsrc.remaining))
    if (nib & 7) != 7 and vsrc.remaining > 0:
        nib |= vsrc.take(1) << 3
    packed = bytearray()
    prev_gt = ((nib << 4) | 0x0F) > 0x8F
    while vsrc.remaining > 0:
        save = vsrc.pos
        chunk7 = vsrc.take(min(7, vsrc.remaining))
        if prev_gt and chunk7 == 0x7F:
            packed.append(0x7F)
            prev_gt = False
        else:
            vsrc.pos = save
            b = vsrc.take(min(8, vsrc.remaining))
            packed.append(b)
            prev_gt = b > 0x8F

    melvlc = bytes(mel_bytes) + bytes(reversed(packed))
    scup = len(melvlc) + 2
    if scup > 4079:
        raise ValueError("cleanup segment too large")
    tail = bytes([(nib << 4) | (scup & 0xF), (scup >> 4) & 0xFF])
    return bytes(magsgn) + melvlc + tail, int(numbps)


@functools.lru_cache(maxsize=128)
def _fields_fn(h: int, w: int, max_mn: int):
    return jax.jit(functools.partial(cleanup_fields, max_mn=max_mn))


def encode_cleanup_blocks(blocks: List[np.ndarray], max_mn: int = 16
                          ) -> List[Tuple[bytes, int, int]]:
    """Host convenience API: encode a batch of int32 code-blocks via the
    device kernel + host serialization.  Pads all blocks to a common even
    shape.  Returns [(segment, numbps, u_max)] like ops/ht.py."""
    if not blocks:
        return []
    hmax = max(b.shape[0] for b in blocks)
    wmax = max(b.shape[1] for b in blocks)
    hmax += hmax & 1
    wmax += wmax & 1
    nb = len(blocks)
    arr = np.zeros((nb, hmax, wmax), np.int32)
    hs = np.zeros(nb, np.int32)
    ws = np.zeros(nb, np.int32)
    for i, b in enumerate(blocks):
        arr[i, :b.shape[0], :b.shape[1]] = b
        hs[i], ws[i] = b.shape
    out = _fields_fn(hmax, wmax, max_mn)(arr, hs, ws)
    out = {k: np.asarray(v) for k, v in out.items()}
    res = []
    for i in range(nb):
        seg, nbps = serialize_block(
            out["ms_words"][i], out["ms_bits"][i],
            out["vlc_words"][i], out["vlc_bits"][i],
            out["mel_words"][i], out["mel_bits"][i],
            int(out["numbps"][i]))
        res.append((seg, nbps, int(out["u_max"][i]) if nbps else 0))
    return res
