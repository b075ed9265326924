"""Fully fused device encode: image batch -> compacted HT bitstreams.

One jitted XLA program per (shape, config) runs DC shift + MCT + multi-level
DWT + code-block split + the HT cleanup field kernel (ops/ht_tpu.py) + stream
compaction.  The device->host fetch is the compacted entropy streams (close
to final codestream size) plus ~20 bytes/block of metadata — never the raw
coefficient pyramid.  The host then only serializes segments (native C++,
byte-oriented MEL/stuffing tails) and assembles Tier-2 packets.

This is the device answer to the reference's hot path: where the reference
runs a goroutine pool of scalar block coders over code-blocks
(/root/reference/encoder.go:690-742, internal/entropy/ht.go:942-1044), here
every block of every frame in the batch is coded by one data-parallel
program, and only byte-stuffing trails on the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..codestream.header import Header
from ..ops import dwt, ht_tpu, mct
from ..tcd import geometry as geo
from ..utils import markers as mk


@dataclasses.dataclass
class BlockPlan:
    """Static per-config geometry: device block order == canonical job order
    (_walk_geometry in models/encoder.py)."""
    nb: int                       # blocks per frame
    cbh: int                      # padded (uniform) block dims
    cbw: int
    hs: np.ndarray                # true per-block dims [nb]
    ws: np.ndarray
    band_specs: List[Tuple]       # (comp, dec_level|0 for LL, name, gy, gx,
                                  #  eff_cbh, eff_cbw, bh, bw, oy, ox) where
                                  #  (oy, ox) = band origin offset within
                                  #  its code-block grid cell (0 for tiles
                                  #  at the canonical origin)
    max_mn: int
    total_pixels: int             # pool caps are adaptive (_caps_for)
    bclass: np.ndarray = None     # per-block band class [nb] (0 LL/LH,
                                  # 1 HL, 2 HH) — device EBCOT path
    mb: np.ndarray = None         # per-block max bitplanes [nb]
    deltas: Tuple = None          # per-band quantizer steps (lossy plans;
                                  # None => reversible, no quantization)


_PLAN_MEMO = {}


def plan_for(header: Header, tile: geo.Tile,
             ht: bool = True, multi_tile: bool = False,
             lossy: bool = False) -> Optional[BlockPlan]:
    """Memoized plan: one BlockPlan (and hence one jit cache entry) per
    codestream configuration.  With multi_tile=True, plans are shared by
    tile-origin CLASS — tiles whose origins agree modulo
    cb_size * 2^levels have identical band/grid offsets everywhere, so one
    compiled kernel serves all of them (at most 4 classes on a uniform
    grid).  lossy=True admits the irreversible 9/7 path: the plan carries
    per-band quantizer steps and the kernel quantizes on device."""
    cs = tile.comps[0].coding
    key = [header.num_components,
           header.components[0].precision, header.components[0].signed,
           cs.num_decompositions, cs.cb_width_exp, cs.cb_height_exp,
           cs.mct, tuple(cs.precincts or ()),
           tile.comps[0].quant.guard_bits, ht, lossy,
           (tile.comps[0].quant.style,
            tuple((s.exponent, s.mantissa)
                  for s in tile.comps[0].quant.step_sizes)) if lossy
           else None]
    if multi_tile:
        mx = 1 << (cs.cb_width_exp + cs.num_decompositions)
        my = 1 << (cs.cb_height_exp + cs.num_decompositions)
        key += [tile.x1 - tile.x0, tile.y1 - tile.y0,
                tile.x0 % mx, tile.y0 % my]
    else:
        key += [header.width, header.height]
    key = tuple(key)
    if key not in _PLAN_MEMO:
        _PLAN_MEMO[key] = plan_blocks(header, tile, ht=ht,
                                      multi_tile=multi_tile, lossy=lossy)
    return _PLAN_MEMO[key]


def plan_blocks(header: Header, tile: geo.Tile,
                ht: bool = True, multi_tile: bool = False,
                lossy: bool = False) -> Optional[BlockPlan]:
    """Build the static block plan, or None if the fast path doesn't apply.

    Gates: no subsampling, uniform
    coding across components, one precinct per band, reversible 5/3, and HT
    code-blocks (ht=True) or plain style-0 EBCOT blocks (ht=False, the
    device EBCOT path).  Default: single tile at the canonical origin.
    multi_tile=True additionally admits tiles at offsets divisible by
    2^levels (the encode_sharded grid gate) — their code-block grids carry
    per-band (oy, ox) offsets handled by _extract_blocks.
    """
    if not multi_tile and (header.num_tiles != 1
                           or tile.x0 != 0 or tile.y0 != 0):
        return None
    if header.coding_style.transform != (0 if lossy else 1):
        return None
    cs0 = tile.comps[0].coding
    if ht and not (cs0.cb_style & mk.CBSTYLE_HT):
        return None
    if not ht and cs0.cb_style != 0:
        return None
    levels = cs0.num_decompositions
    if multi_tile and ((tile.x0 % (1 << levels))
                       or (tile.y0 % (1 << levels))):
        return None
    cbh, cbw = 1 << cs0.cb_height_exp, 1 << cs0.cb_width_exp
    hs: List[int] = []
    ws: List[int] = []
    bclass: List[int] = []
    mbs: List[int] = []
    band_specs: List[Tuple] = []
    deltas: List[float] = []
    max_mb = 0
    band_cls = {"LL": 0, "LH": 0, "HL": 1, "HH": 2}
    for c, tc in enumerate(tile.comps):
        if tc.x0 != tile.x0 or tc.y0 != tile.y0:
            return None
        if (tc.coding.cb_width_exp != cs0.cb_width_exp
                or tc.coding.cb_height_exp != cs0.cb_height_exp
                or tc.coding.num_decompositions != cs0.num_decompositions
                or tc.coding.cb_style != cs0.cb_style):
            return None
        hdr_c = header.components[c]
        if hdr_c.dx != 1 or hdr_c.dy != 1:
            return None
        for res in tc.resolutions:
            for band in res.bands:
                if len(band.precincts) != 1:
                    return None
                prec = band.precincts[0]
                eh, ew = 1 << res.cb_h_exp, 1 << res.cb_w_exp
                bh, bw = band.h, band.w
                if bh == 0 or bw == 0:
                    if prec.code_blocks:
                        return None
                    continue
                # block grid anchored at multiples of (eh, ew) in band
                # coords (B.7): offset of the band origin within its cell
                oy, ox = band.y0 % eh, band.x0 % ew
                gy = geo.ceil_div(bh + oy, eh)
                gx = geo.ceil_div(bw + ox, ew)
                if len(prec.code_blocks) != gy * gx:
                    return None
                mb = tc.quant.guard_bits + band.eps - 1
                gx0 = band.x0 - ox
                gy0 = band.y0 - oy
                # geometry emits row-major grid blocks — verify
                for i, cb in enumerate(prec.code_blocks):
                    yy, xx = divmod(i, gx)
                    if (cb.x0 != max(gx0 + xx * ew, band.x0)
                            or cb.y0 != max(gy0 + yy * eh, band.y0)):
                        return None
                    hs.append(cb.h)
                    ws.append(cb.w)
                    bclass.append(band_cls[band.name])
                    mbs.append(mb)
                band_specs.append((c, band.dec_level if band.name != "LL"
                                   else 0, band.name, gy, gx, eh, ew, bh, bw,
                                   oy, ox))
                deltas.append(float(band.delta))
                max_mb = max(max_mb, mb)
    nb = len(hs)
    if nb == 0:
        return None
    hs_a = np.asarray(hs, np.int32)
    ws_a = np.asarray(ws, np.int32)
    total_px = int((hs_a.astype(np.int64) * ws_a).sum())
    max_mn = min(31, max_mb + 2)
    return BlockPlan(nb=nb, cbh=cbh, cbw=cbw, hs=hs_a, ws=ws_a,
                     band_specs=band_specs, max_mn=max_mn,
                     total_pixels=total_px,
                     bclass=np.asarray(bclass, np.int32),
                     mb=np.asarray(mbs, np.int32),
                     deltas=tuple(deltas) if lossy else None)


def _extract_blocks(pyr, plan: BlockPlan, n: int, nl: int):
    """Pyramid leaves [N, C, bh, bw] -> block batch [N*nb, CBH, CBW] in
    canonical job order (frame-major).

    Offset grids (multi-tile plans): the band content is padded into its
    grid-aligned footprint, which leaves first-row/first-column slots with
    their valid samples at (oy, ox) instead of the kernel's expected
    top-left anchor — those slots are rolled up/left (the vacated area is
    zero padding, so the roll is clean)."""
    per_band = []
    for bi, (c, lev, name, gy, gx, eh, ew, bh, bw, oy, ox) in \
            enumerate(plan.band_specs):
        if name == "LL":
            a = pyr[nl - 1]["LL"][:, c] if nl > 0 else pyr[0]["LL"][:, c]
        else:
            a = pyr[lev - 1][name][:, c]
        if plan.deltas is not None:
            # deadzone scalar quantization (E.1.1) on device, float32 —
            # the host path quantizes in float32 too (models/encoder.py
            # _entropy_jobs) so the indices agree bit-for-bit
            d = jnp.float32(plan.deltas[bi])
            a = (jnp.sign(a)
                 * jnp.floor(jnp.abs(a) / d)).astype(jnp.int32)
        ph, pw = gy * eh, gx * ew
        a = jnp.pad(a, ((0, 0), (oy, ph - bh - oy), (ox, pw - bw - ox)))
        a = a.reshape(n, gy, eh, gx, ew).transpose(0, 1, 3, 2, 4)
        a = a.reshape(n, gy, gx, eh, ew)
        if oy:
            a = jnp.concatenate(
                [jnp.roll(a[:, :1], -oy, axis=-2), a[:, 1:]], axis=1)
        if ox:
            a = jnp.concatenate(
                [jnp.roll(a[:, :, :1], -ox, axis=-1), a[:, :, 1:]], axis=2)
        a = a.reshape(n, gy * gx, eh, ew)
        if (eh, ew) != (plan.cbh, plan.cbw):
            a = jnp.pad(a, ((0, 0), (0, 0), (0, plan.cbh - eh),
                            (0, plan.cbw - ew)))
        per_band.append(a)
    blocks = jnp.concatenate(per_band, axis=1)      # [N, nb, CBH, CBW]
    return blocks.reshape(n * plan.nb, plan.cbh, plan.cbw)


@functools.lru_cache(maxsize=64)
def _fused_fn(n: int, c: int, h: int, w: int, levels: int, use_mct: bool,
              precision: int, signed: bool, plan_key: int,
              cap_ms: int, cap_vlc: int, cap_mel: int,
              kind: str = dwt.REV53):
    plan = _PLANS[plan_key]
    # NumPy (not jnp) on purpose: these trace into the program as HLO
    # literals.  A captured *device* array would become a per-call constant
    # argument, re-supplied on every call.
    hs = np.tile(plan.hs, n)
    ws = np.tile(plan.ws, n)

    def fn(batch_flat):
        # flat upload: one contiguous h2d copy, reshaped on device
        batch = batch_flat.reshape(n, c, h, w)
        x = batch.astype(jnp.int32)
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
        pyr = dwt.decompose(x, levels, kind)
        blocks = _extract_blocks(pyr, plan, n, levels)
        return ht_tpu.cleanup_fields_compact(
            blocks, hs, ws, plan.max_mn, cap_ms, cap_vlc, cap_mel)

    return jax.jit(fn)


_PLANS = {}


def _plan_key(plan: BlockPlan) -> int:
    k = id(plan)
    _PLANS[k] = plan
    return k


class FusedDispatch:
    """Handle for one in-flight fused-encode chunk."""

    def __init__(self, out, n: int, plan: BlockPlan, caps):
        self.out, self.n, self.plan, self.caps = out, n, plan, caps


# per-plan adaptive cap state: observed high-water bits/sample for the
# MagSgn and VLC streams.  Caps snap to a 1.1^k grid so each plan compiles
# only a handful of variants (cached persistently), while the static pools
# stay within ~18% of the actual stream size (the device sorts and compacts
# the full cap, so oversized caps cost device time).
_CAP_STATE = {}


def _grid(bps: float) -> float:
    g = 0.5
    while g < bps:
        g *= 1.1
    return g


def _caps_for(plan: BlockPlan, n: int):
    hw_ms, hw_vlc = _CAP_STATE.get(id(plan), (3.0, 2.0))
    # hard information-theoretic ceilings keep runaway observations from
    # inflating pool shapes (and with them XLA sort/compile sizes): the
    # MagSgn stream carries at most max_mn bits per sample and the VLC
    # stream at most ~31 bits per quad-pair (~4 bits/sample)
    hw_ms = min(hw_ms, float(plan.max_mn))
    hw_vlc = min(hw_vlc, 6.0)
    ms_bps = _grid(hw_ms * 1.06)
    vlc_bps = _grid(hw_vlc * 1.06)
    cap_ms = -(-int(plan.total_pixels * ms_bps / 32) // 256) * 256 + 256
    cap_vlc = -(-int(plan.total_pixels * vlc_bps / 32) // 256) * 256 + 256
    cap_mel = int(plan.total_pixels * 3 / 8 / 32) + 256
    return cap_ms * n, cap_vlc * n, cap_mel * n


def _observe_bps(plan: BlockPlan, ms_bits, vlc_bits, n: int):
    px = max(1, plan.total_pixels * n)
    hw_ms, hw_vlc = _CAP_STATE.get(id(plan), (3.0, 2.0))
    _CAP_STATE[id(plan)] = (max(hw_ms, float(ms_bits.sum()) / px),
                            max(hw_vlc, float(vlc_bits.sum()) / px))


def _grow_caps(plan: BlockPlan, d: "FusedDispatch" = None):
    """Raise the adaptive caps after a pool overflow.  When the dispatch is
    provided, its META block (already fetched) carries the ACTUAL per-block
    bit counts — jump the high-water straight there so the retry compiles
    exactly ONE corrected program.  The blind x1.5 ladder otherwise climbs
    across encodes (16-bit content needs ~5x the 8-bit default), paying an
    XLA compile per rung."""
    hw_ms, hw_vlc = _CAP_STATE.get(id(plan), (3.0, 2.0))
    if d is None:
        _CAP_STATE[id(plan)] = (hw_ms * 1.5, hw_vlc * 1.5)
        return
    from ..utils import fetch
    _out, meta_fetch = d.out
    meta = fetch.gather(meta_fetch).view(np.int32).reshape(6, d.plan.nb * d.n)
    px = max(1, d.plan.total_pixels * d.n)
    _CAP_STATE[id(plan)] = (
        max(hw_ms, float(meta[0].astype(np.int64).sum()) / px),
        max(hw_vlc, float(meta[1].astype(np.int64).sum()) / px))


@functools.lru_cache(maxsize=512)
def _slice_fn(start: int, length: int):
    import jax

    return jax.jit(lambda x: jax.lax.slice_in_dim(x, start, start + length,
                                                  axis=0))


def _bucket_words(used: int, cap: int) -> int:
    """Snap a dynamic fetch length to a 1.25^k word grid (bounded compile
    variants, <=25% over-fetch) capped at the static pool size."""
    g = 1 << 16
    while g < used:
        g = int(g * 1.25)
    return min(g, cap)


def dispatch(batch: np.ndarray, levels: int, use_mct: bool, precision: int,
             signed: bool, plan: BlockPlan,
             kind: str = dwt.REV53) -> FusedDispatch:
    n, c, h, w = batch.shape
    caps = _caps_for(plan, n)
    fn = _fused_fn(n, c, h, w, levels, use_mct, precision, signed,
                   _plan_key(plan), *caps, kind=kind)
    # async h2d first so the upload overlaps other chunks' compute/fetch
    import jax
    from ..utils import fetch
    flat = jax.device_put(np.ascontiguousarray(batch).reshape(-1))
    out = fn(flat)
    # two-phase fetch: the tiny meta block starts copying immediately; the
    # pools are fetched later as USED-prefix slices only (the static caps
    # overshoot the actual streams 20-70%)
    nmeta = 6 * plan.nb * n
    meta_fetch = fetch.fetch_async(_slice_fn(0, nmeta)(out))
    return FusedDispatch((out, meta_fetch), n, plan, caps)


def _gather_pools(d: FusedDispatch):
    """Blocks on the meta fetch, then fetches only the used prefix of each
    stream pool (bucketed slice sizes).  Returns (meta int32 [6, nb*n],
    pools uint32 laid out exactly like the static caps region), or None on
    pool overflow."""
    from ..utils import fetch
    out, meta_fetch = d.out
    plan, n = d.plan, d.n
    cap_ms, cap_vlc, cap_mel = d.caps
    nmeta = 6 * plan.nb * n
    meta = fetch.gather(meta_fetch).view(np.int32).reshape(6, plan.nb * n)
    ms_bits, vlc_bits, mel_bits = meta[0], meta[1], meta[2]

    def used_words(bits):
        return int(((bits.astype(np.int64) + 31) >> 5).sum())

    useds = [used_words(ms_bits), used_words(vlc_bits),
             used_words(mel_bits)]
    caps = [cap_ms, cap_vlc, cap_mel]
    if any(u > c for u, c in zip(useds, caps)):
        return meta, None                      # overflow: caller grows caps
    bases = [nmeta, nmeta + cap_ms, nmeta + cap_ms + cap_vlc]
    handles = []
    for base, cap, used in zip(bases, caps, useds):
        blen = _bucket_words(used, cap)
        handles.append((base - nmeta, blen,
                        fetch.fetch_async(_slice_fn(base, blen)(out))))
    pools = np.zeros(cap_ms + cap_vlc + cap_mel, np.uint32)
    for off, blen, hnd in handles:
        pools[off:off + blen] = fetch.gather(hnd)
    return meta, pools


def fetch_segments(d: FusedDispatch
                   ) -> Optional[List[List[Tuple[bytes, int, float]]]]:
    """Blocks on the device result; serializes all blocks natively.

    Returns per-frame lists of (segment, numbps, distortion), or None on
    pool overflow (caller grows the caps and retries / falls back)."""
    from ..native import loader
    plan, n = d.plan, d.n
    cap_ms, cap_vlc, cap_mel = d.caps
    meta, pool = _gather_pools(d)
    if pool is None:
        return None
    ms_bits, vlc_bits, mel_bits, numbps, _u_max = meta[:5]
    dist = meta[5].view(np.float32)
    ms_off, ms_nw, ovf1 = ht_tpu.pool_offsets(ms_bits, 0, cap_ms)
    vlc_off, vlc_nw, ovf2 = ht_tpu.pool_offsets(vlc_bits, cap_ms, cap_vlc)
    mel_off, mel_nw, ovf3 = ht_tpu.pool_offsets(
        mel_bits, cap_ms + cap_vlc, cap_mel)
    if ovf1 or ovf2 or ovf3:
        return None
    _observe_bps(plan, ms_bits, vlc_bits, n)
    segs = loader.ht_serialize_blocks(
        pool, ms_off, ms_nw, ms_bits, vlc_off, vlc_nw, vlc_bits,
        mel_off, mel_nw, mel_bits, numbps.astype(np.int32))
    nb = plan.nb
    out = []
    for i in range(n):
        out.append([(segs[i * nb + j], int(numbps[i * nb + j]),
                     float(dist[i * nb + j])) for j in range(nb)])
    return out


# ---------------------------------------------------------------------------
# Native single-layer T2: flat geometry arrays for j2k_native's packet walk.
# ---------------------------------------------------------------------------

_GEOM_MEMO = {}


def t2_geom(header: Header, tile: geo.Tile, plan: BlockPlan):
    """Flatten the packet walk (progression order, single layer) into the
    arrays ht_t2_{en,de}code_frames consume.  Block ids are the canonical
    job order (models/encoder.py::_walk_geometry)."""
    key = id(plan)
    if key in _GEOM_MEMO:
        return _GEOM_MEMO[key]
    from ..tcd import t2 as t2_mod

    # canonical job order walk: id per block + per-block mb
    state = {}
    mb_list = []
    next_id = 0
    for c, tc in enumerate(tile.comps):
        for res in tc.resolutions:
            for band in res.bands:
                mb = tc.quant.guard_bits + band.eps - 1
                for p_idx, prec in enumerate(band.precincts):
                    state.setdefault((c, res.r, p_idx), []).append(
                        (prec, next_id))
                    for cb in prec.code_blocks:
                        mb_list.append(mb)
                        next_id += 1
    assert next_id == plan.nb

    seq = t2_mod.packet_sequence(tile, header)
    # single layer: keep layer-0 packets only (callers gate num_layers == 1)
    seq = [p for p in seq if p.layer == 0]
    pkt_nbp = []
    bp_cbw = []
    bp_cbh = []
    bp_nblocks = []
    bp_blocks = []
    bp_block_xy = []
    for pid in seq:
        entries = state.get((pid.comp, pid.res, pid.precinct), [])
        pkt_nbp.append(len(entries))
        for prec, base in entries:
            bp_cbw.append(prec.cbw)
            bp_cbh.append(prec.cbh)
            bp_nblocks.append(len(prec.code_blocks))
            for i, cb in enumerate(prec.code_blocks):
                bp_blocks.append(base + i)
                bp_block_xy += [cb.cbx, cb.cby]
    geom = {
        "n_packets": len(seq),
        "pkt_nbp": np.asarray(pkt_nbp, np.int32),
        "bp_cbw": np.asarray(bp_cbw, np.int32),
        "bp_cbh": np.asarray(bp_cbh, np.int32),
        "bp_nblocks": np.asarray(bp_nblocks, np.int32),
        "bp_blocks": np.asarray(bp_blocks, np.int32),
        "bp_block_xy": np.asarray(bp_block_xy, np.int32),
        "mb": np.asarray(mb_list, np.int32),
    }
    _GEOM_MEMO[key] = geom
    return geom


def fetch_bodies(d: FusedDispatch, header: Header, tile: geo.Tile
                 ) -> Optional[List[bytes]]:
    """Single-layer fast path: fetch + native serialize + native T2 in one
    call per chunk.  Returns per-frame tile-body bytes (packets only), or
    None on pool overflow."""
    from ..native import loader
    plan, n = d.plan, d.n
    cap_ms, cap_vlc, cap_mel = d.caps
    meta, pool = _gather_pools(d)
    if pool is None:
        return None
    ms_bits, vlc_bits, mel_bits, numbps = meta[0], meta[1], meta[2], meta[3]
    ms_off, ms_nw, ovf1 = ht_tpu.pool_offsets(ms_bits, 0, cap_ms)
    vlc_off, vlc_nw, ovf2 = ht_tpu.pool_offsets(vlc_bits, cap_ms, cap_vlc)
    mel_off, mel_nw, ovf3 = ht_tpu.pool_offsets(
        mel_bits, cap_ms + cap_vlc, cap_mel)
    if ovf1 or ovf2 or ovf3:
        return None
    _observe_bps(plan, ms_bits, vlc_bits, n)
    geom = t2_geom(header, tile, plan)
    mb = np.tile(geom["mb"], n)
    # cleanup-only HT convention (matches the host path + OpenJPEG interop):
    # one coding pass -> signal a single magnitude bitplane (zbp = Mb - 1)
    zbp = np.where(numbps > 0, mb - 1, mb).astype(np.int32)
    return loader.ht_t2_encode_frames(
        pool, ms_off, ms_nw, ms_bits, vlc_off, vlc_nw, vlc_bits,
        mel_off, mel_nw, mel_bits, numbps.astype(np.int32), zbp,
        n, plan.nb, geom)
