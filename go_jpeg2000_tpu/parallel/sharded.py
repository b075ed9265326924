"""Spatially-sharded DWT with halo exchange + sharded encode step.

The sequence-parallelism analog for a codec (SURVEY.md §5.7): rows of a
tile-component shard over the 'sp' mesh axis; each lifting step (two for
the reversible 5/3, four + K scaling for the irreversible 9/7) needs one
boundary row from the neighboring shard, exchanged with jax.lax.ppermute
(device-to-device, over NVLink between GPUs).  Rate-allocation statistics
reduce with psum — the PCRD allreduce of BASELINE.json config 5.

Shapes must satisfy H % (sp * 2^levels) == 0 so every shard starts on an
even global row at every level (asserted in the wrapper).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import dwt


def _odd_update_sharded(evens, odds, axis_name, f):
    """odds[k] = f(odds[k], evens[k], even_below[k]) on row-shards whose
    global start row is even.  The even row below odd row k is evens[k+1];
    the last odd row needs the NEXT shard's first even row (exchanged with
    ppermute), and the global bottom shard reflects (X[H] -> X[H-2], i.e.
    its own evens[-1] — H is even under the encode_sharded gates)."""
    sp = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    from_next = jax.lax.ppermute(evens[..., 0:1, :], axis_name,
                                 [(i, (i - 1) % sp) for i in range(sp)])
    bottom_fill = evens[..., -1:, :]
    below_last = jnp.where(idx == sp - 1, bottom_fill, from_next)
    even_below = jnp.concatenate([evens[..., 1:, :], below_last], axis=-2)
    return f(odds, evens, even_below)


def _even_update_sharded(evens, odds, axis_name, f):
    """evens[k] = f(evens[k], odd_above[k], odds[k]): the odd row above
    even row k is odds[k-1]; the first even row needs the PREVIOUS shard's
    last odd row, and the global top shard reflects (X[-1] -> X[1], i.e.
    its own odds[0])."""
    sp = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    from_prev = jax.lax.ppermute(odds[..., -1:, :], axis_name,
                                 [(i, (i + 1) % sp) for i in range(sp)])
    top_fill = odds[..., 0:1, :]
    above_first = jnp.where(idx == 0, top_fill, from_prev)
    odd_above = jnp.concatenate([above_first, odds[..., :-1, :]], axis=-2)
    return f(evens, odd_above, odds)


def _interleave_rows(evens, odds):
    shp = list(evens.shape)
    shp[-2] = evens.shape[-2] + odds.shape[-2]
    out = jnp.stack([evens, odds], axis=-2)   # [..., rows/2, 2, W]
    return out.reshape(shp)


def _vlift53_sharded(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Vertical 5/3 forward lifting on a row-shard [..., rows, W] whose global
    start row is even; boundary rows exchanged with the neighbor shards."""
    evens = x[..., 0::2, :]
    odds = x[..., 1::2, :]
    # step 1: odd rows -= floor((even_above + even_below)/2)
    odds = _odd_update_sharded(evens, odds, axis_name,
                               lambda c, l, r: c - ((l + r) >> 1))
    # step 2: even rows += floor((odd_above + odd_below + 2)/4)
    evens = _even_update_sharded(evens, odds, axis_name,
                                 lambda c, l, r: c + ((l + r + 2) >> 2))
    return evens, odds


def _vlift53_inverse_sharded(low: jnp.ndarray, high: jnp.ndarray,
                             axis_name: str) -> jnp.ndarray:
    """Inverse of :func:`_vlift53_sharded` (same halo pattern, reversed)."""
    evens, odds = low, high
    evens = _even_update_sharded(evens, odds, axis_name,
                                 lambda c, l, r: c - ((l + r + 2) >> 2))
    odds = _odd_update_sharded(evens, odds, axis_name,
                               lambda c, l, r: c + ((l + r) >> 1))
    return _interleave_rows(evens, odds)


def _vlift97_sharded(x: jnp.ndarray, axis_name: str):
    """Vertical irreversible 9/7 forward lifting (F.4.8.2) on a row-shard:
    four lifting steps, each exchanging one boundary row over 'sp', then
    the K scaling.  Same per-sample arithmetic as ops.dwt._forward_1d_97."""
    evens = x[..., 0::2, :]
    odds = x[..., 1::2, :]
    odds = _odd_update_sharded(evens, odds, axis_name,
                               lambda c, l, r: c + dwt.ALPHA * (l + r))
    evens = _even_update_sharded(evens, odds, axis_name,
                                 lambda c, l, r: c + dwt.BETA * (l + r))
    odds = _odd_update_sharded(evens, odds, axis_name,
                               lambda c, l, r: c + dwt.GAMMA * (l + r))
    evens = _even_update_sharded(evens, odds, axis_name,
                                 lambda c, l, r: c + dwt.DELTA * (l + r))
    return evens * (1.0 / dwt.K), odds * dwt.K


def _vlift97_inverse_sharded(low: jnp.ndarray, high: jnp.ndarray,
                             axis_name: str) -> jnp.ndarray:
    """Inverse of :func:`_vlift97_sharded` (same halo pattern, reversed)."""
    evens = low * dwt.K
    odds = high * (1.0 / dwt.K)
    evens = _even_update_sharded(evens, odds, axis_name,
                                 lambda c, l, r: c - dwt.DELTA * (l + r))
    odds = _odd_update_sharded(evens, odds, axis_name,
                               lambda c, l, r: c - dwt.GAMMA * (l + r))
    evens = _even_update_sharded(evens, odds, axis_name,
                                 lambda c, l, r: c - dwt.BETA * (l + r))
    odds = _odd_update_sharded(evens, odds, axis_name,
                               lambda c, l, r: c - dwt.ALPHA * (l + r))
    return _interleave_rows(evens, odds)


def dwt_level_sharded(x: jnp.ndarray, axis_name: str, kind: str = dwt.REV53
                      ) -> Dict[str, jnp.ndarray]:
    """One 2-D level on a row-sharded tile: vertical lifting with halo
    exchange, then local horizontal lifting."""
    vlift = _vlift53_sharded if kind == dwt.REV53 else _vlift97_sharded
    lo_y, hi_y = vlift(x, axis_name)
    ll, hl = dwt.forward_1d(lo_y, kind, axis=-1, parity=0)
    lh, hh = dwt.forward_1d(hi_y, kind, axis=-1, parity=0)
    return {"LL": ll, "HL": hl, "LH": lh, "HH": hh}


def idwt_level_sharded(bands: Dict[str, jnp.ndarray], axis_name: str,
                       kind: str = dwt.REV53) -> jnp.ndarray:
    lo_y = dwt.inverse_1d(bands["LL"], bands["HL"], kind, axis=-1, parity=0)
    hi_y = dwt.inverse_1d(bands["LH"], bands["HH"], kind, axis=-1, parity=0)
    vinv = (_vlift53_inverse_sharded if kind == dwt.REV53
            else _vlift97_inverse_sharded)
    return vinv(lo_y, hi_y, axis_name)


def dwt_multilevel_sharded(x: jnp.ndarray, levels: int, axis_name: str,
                           kind: str = dwt.REV53
                           ) -> List[Dict[str, jnp.ndarray]]:
    out = []
    cur = x
    for lev in range(1, levels + 1):
        bands = dwt_level_sharded(cur, axis_name, kind)
        entry = {k: bands[k] for k in ("HL", "LH", "HH")}
        cur = bands["LL"]
        if lev == levels:
            entry["LL"] = cur
        out.append(entry)
    return out


def idwt_multilevel_sharded(pyramid: List[Dict[str, jnp.ndarray]],
                            axis_name: str, kind: str = dwt.REV53
                            ) -> jnp.ndarray:
    cur = pyramid[-1]["LL"]
    for lev in range(len(pyramid), 0, -1):
        entry = pyramid[lev - 1]
        cur = idwt_level_sharded(
            {"LL": cur, "HL": entry["HL"], "LH": entry["LH"],
             "HH": entry["HH"]}, axis_name, kind)
    return cur


# Reversible-path aliases (the original 5/3-only API, kept for callers
# and tests that predate the 9/7 extension).
def dwt53_level_sharded(x, axis_name):
    return dwt_level_sharded(x, axis_name, dwt.REV53)


def idwt53_level_sharded(bands, axis_name):
    return idwt_level_sharded(bands, axis_name, dwt.REV53)


def dwt53_multilevel_sharded(x, levels, axis_name):
    return dwt_multilevel_sharded(x, levels, axis_name, dwt.REV53)


def idwt53_multilevel_sharded(pyramid, axis_name):
    return idwt_multilevel_sharded(pyramid, axis_name, dwt.REV53)


class MeshComm:
    """Scalar allreduce over the mesh for the distributed PCRD bisection
    (models/rate.assign_layers_sharded): each dp shard contributes one
    local value; sum/max/min run as real XLA collectives (psum/pmax/pmin
    across the mesh's devices).  The caller passes a [dp] vector of
    per-shard locals; the reduction result is identical on every shard, so
    all shards derive the same slope threshold.

    Exactness: float64 is off by default in JAX (jax_enable_x64), and a
    silent f64->f32 cast would let byte totals above 2^24 (and slope
    extrema) round differently than the single-host float64 reducer,
    breaking the documented bit-identity with assign_layers.  So the
    collectives never
    carry floats: `sum` decomposes each value into 16-bit integer limbs and
    psums them as int32 (exact for |value| < 2^53, the full f64-integer
    range — PCRD sums are integer byte totals and counts); `max`/`min`
    reduce the IEEE-754 sortable-key encoding of the f64 as two uint32
    words (pmax on the high word, then a masked pmax on the low word), which
    is exact for every finite value, +/-inf included."""

    # 4 limbs x 16 bits cover the 53-bit exact-integer range of float64
    _NLIMB = 4

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        axes = tuple(mesh.shape.keys())
        from jax import shard_map

        def wrap(local):
            return jax.jit(shard_map(
                local, mesh=mesh, in_specs=(P(axes),), out_specs=P(axes),
                check_vma=False))

        def psum_all(x):
            for ax in axes:
                x = jax.lax.psum(x, ax)
            return x

        def pext_all(x, op):
            for ax in axes:
                x = op(x, ax)
            return x

        def sum_limbs(limbs):           # [1, NLIMB] int32 per shard
            return psum_all(limbs)

        def ext_key(hi_lo, use_max):    # [1, 2] uint32 per shard
            hi, lo = hi_lo[..., 0], hi_lo[..., 1]
            op = jax.lax.pmax if use_max else jax.lax.pmin
            hi_r = pext_all(hi, op)
            fill = jnp.uint32(0) if use_max else jnp.uint32(0xFFFFFFFF)
            lo_r = pext_all(jnp.where(hi == hi_r, lo, fill), op)
            return jnp.stack([hi_r, lo_r], axis=-1)

        self._sum = wrap(sum_limbs)
        self._max = wrap(functools.partial(ext_key, use_max=True))
        self._min = wrap(functools.partial(ext_key, use_max=False))
        self._n = 1
        for ax in axes:
            self._n *= mesh.shape[ax]

    @staticmethod
    def _to_key(v):
        """IEEE-754 double -> monotone uint64 sort key."""
        import numpy as np
        bits = np.asarray(v, np.float64).view(np.uint64)
        neg = (bits >> np.uint64(63)) != 0
        return np.where(neg, ~bits, bits | np.uint64(1) << np.uint64(63))

    @staticmethod
    def _from_key(k):
        import numpy as np
        k = np.uint64(k)
        if k >> np.uint64(63):
            bits = k & ~(np.uint64(1) << np.uint64(63))
        else:
            bits = ~k
        return float(np.uint64(bits).view(np.float64))

    def __call__(self, vec, op: str):
        import numpy as np
        v = np.zeros((self._n,), np.float64)
        v[:len(vec)] = np.asarray(vec, np.float64)
        if op == "sum":
            iv = np.rint(v).astype(np.int64)
            if not np.array_equal(iv.astype(np.float64), v):
                raise ValueError("MeshComm sum requires integer-valued "
                                 "inputs (PCRD byte totals/counts)")
            limbs = np.stack([(iv >> (16 * i)) & 0xFFFF
                              for i in range(self._NLIMB)],
                             axis=-1).astype(np.int32)
            red = np.asarray(self._sum(limbs)).astype(np.int64)[0]
            total = 0
            for i in range(self._NLIMB):
                total += int(red[i]) << (16 * i)
            # limbs are unsigned 16-bit pieces of a signed int64: sign-extend
            if total >= 1 << 63:
                total -= 1 << 64
            return float(total)
        if op == "max" and len(vec) < self._n:
            v[len(vec):] = -np.inf
        if op == "min" and len(vec) < self._n:
            v[len(vec):] = np.inf
        keys = self._to_key(v)
        hi_lo = np.stack([(keys >> np.uint64(32)).astype(np.uint32),
                          (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                         axis=-1)
        fn = self._max if op == "max" else self._min
        red = np.asarray(fn(hi_lo))[0]
        return self._from_key((np.uint64(red[0]) << np.uint64(32))
                              | np.uint64(red[1]))


@functools.lru_cache(maxsize=8)
def _mesh_comm(mesh: Mesh) -> MeshComm:
    """One MeshComm (and its three compiled reducers) per mesh."""
    return MeshComm(mesh)


@functools.lru_cache(maxsize=32)
def make_tile_transform_step(mesh: Mesh, levels: int, use_mct: bool,
                             precision: int, signed: bool,
                             kind: str = dwt.REV53):
    """Jitted mesh-sharded forward transform over a tile batch.

    Input [T, C, th, tw] (native int dtype): tiles shard over 'dp', rows
    over 'sp'.  Runs DC shift + RCT/ICT + the sharded multi-level DWT
    (5/3 reversible or 9/7 irreversible; halo exchange via ppermute on
    'sp') and psum-reduces per-band squared energies (the
    device-computable half of the rate-allocation stats).
    Returns (pyramid leaves as a list of dicts of [T, C, h, w], stats).
    """

    def local_step(batch):
        from ..ops import mct
        x = batch.astype(jnp.int32)
        if not signed:
            x = x - (1 << (precision - 1))
        if use_mct and x.shape[1] >= 3:
            if kind == dwt.REV53:
                y, u, v = mct.forward_rct(x[:, 0], x[:, 1], x[:, 2])
            else:
                y, u, v = mct.forward_ict(x[:, 0], x[:, 1], x[:, 2])
            rest = [x[:, i] for i in range(3, x.shape[1])]
            x = jnp.stack([y, u, v] + rest, axis=1)
        if kind == dwt.IRR97:
            x = x.astype(jnp.float32)
        pyr = dwt_multilevel_sharded(x, levels, "sp", kind)
        stats = []
        for entry in pyr:
            for k in ("HL", "LH", "HH", "LL"):
                if k not in entry:
                    continue
                a = entry[k].astype(jnp.float32)
                stats.append(jnp.stack([jnp.sum(a * a),
                                        jnp.sum((a != 0).astype(jnp.float32))]))
        stats = jnp.stack(stats)
        stats = jax.lax.psum(jax.lax.psum(stats, "sp"), "dp")
        return pyr, stats

    from jax import shard_map
    in_spec = P("dp", None, "sp", None)
    out_spec = (P("dp", None, "sp", None), P())
    fn = shard_map(local_step, mesh=mesh, in_specs=(in_spec,),
                   out_specs=out_spec, check_vma=False)
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _shard_fields_fn(plan_key: int, idxs: Tuple[int, ...], levels: int,
                     cap_ms: int, cap_vlc: int, cap_mel: int):
    """Jitted device HT entropy over one tile-class group of the sharded
    pyramid: gather the group's tiles from the (dp, sp)-sharded leaves
    (XLA inserts the collectives), extract code-blocks, run the cleanup
    field kernel + stream compaction (ops/ht_tpu.py).  One compiled
    program per tile-origin class, shared by every tile in the class."""
    from ..models import fused_encode
    from ..ops import ht_tpu
    plan = fused_encode._PLANS[plan_key]
    n = len(idxs)
    idx_a = np.asarray(idxs, np.int32)
    hs = np.tile(plan.hs, n)
    ws = np.tile(plan.ws, n)

    def fn(pyr):
        sub = jax.tree_util.tree_map(
            lambda a: jnp.take(a, idx_a, axis=0), pyr)
        blocks = fused_encode._extract_blocks(sub, plan, n, levels)
        return ht_tpu.cleanup_fields_compact(
            blocks, hs, ws, plan.max_mn, cap_ms, cap_vlc, cap_mel)

    return jax.jit(fn)


def _device_ht_entropy(header, opts, pyr, T: int, num_layers: int,
                       rate_budget):
    """Device HT entropy for the sharded pipeline (VERDICT r4 next #1):
    the per-shard HOST entropy loop is replaced by the fused HT field
    kernel running on the mesh-resident pyramid — the host only serializes
    segments (native C++ byte-stuffing tails) and assembles Tier-2.

    Returns {tile_index: [(seg, numbps, dist)]} in canonical job order, or
    None when any tile is ineligible (caller falls back to host entropy).
    Byte-identity with the host coder is differential-tested
    (tests/test_sharded_pipeline.py::test_sharded_ht_device_entropy)."""
    from ..models import fused_encode
    from ..native import loader
    from ..tcd import geometry as geo
    from ..models.encoder import effective_ht_refinement
    if not (opts.high_throughput and not effective_ht_refinement(opts)):
        return None
    if opts.backend == "python":
        return None
    # PCRD inputs must match the host path BIT-for-bit for the documented
    # byte-identity contract; the device kernel's f32 distortion sums could
    # flip a threshold comparison when layers/budgets consume them, so the
    # device path serves the single-layer unbudgeted config only.
    if num_layers != 1 or rate_budget is not None:
        return None
    loader.require()
    levels = header.coding_style.num_decompositions
    lossy = header.coding_style.transform == 0
    groups: Dict[int, List[int]] = {}
    plans: Dict[int, object] = {}
    for t in range(T):
        tile = geo.build_tile(header, t)
        plan = fused_encode.plan_for(header, tile, ht=True, multi_tile=True,
                                     lossy=lossy)
        if plan is None:
            return None
        k = fused_encode._plan_key(plan)
        groups.setdefault(k, []).append(t)
        plans[k] = plan

    from ..utils.metrics import counters
    counters.add("enc.sharded_device_ht_tiles", T)
    out: Dict[int, List] = {}
    for k, tidx in groups.items():
        plan = plans[k]
        n = len(tidx)
        segs = None
        for _attempt in range(4):
            caps = fused_encode._caps_for(plan, n)
            fn = _shard_fields_fn(k, tuple(tidx), levels, *caps)
            dev = fn(pyr)
            from ..utils import fetch
            nmeta = 6 * plan.nb * n
            meta_fetch = fetch.fetch_async(
                fused_encode._slice_fn(0, nmeta)(dev))
            d = fused_encode.FusedDispatch((dev, meta_fetch), n, plan, caps)
            segs = fused_encode.fetch_segments(d)
            if segs is not None:
                break
            fused_encode._grow_caps(plan, d)  # overflow: jump caps to
                                                  # the observed bits
        if segs is None:
            return None
        for i, t in enumerate(tidx):
            out[t] = segs[i]
    return out


def encode_sharded(image, mesh: Mesh, opts=None):
    """Mesh-sharded encode of a multi-tile image -> complete codestream.

    The full BASELINE config-4/5 pipeline: tiles shard over 'dp' (the
    multi-host axis), tile rows over 'sp' (spatial axis with ppermute halo
    exchange); the transform runs as ONE jitted mesh program; entropy
    coding runs per dp-shard on host (each shard's tiles — the per-host
    work); PCRD layer allocation is GLOBAL via
    rate.assign_layers_sharded with MeshComm psum/pmax collectives; Tier-2
    and codestream assembly are host-side.  Reversible (5/3) output is
    byte-identical to models.encoder.encode(image, opts) — asserted by
    tests/test_sharded_pipeline.py and __graft_entry__.dryrun_multichip.
    Irreversible (9/7 + deadzone quant, on device) output matches the
    single-device encoder to quality parity (float32 DWT ulps may differ
    between program shapes; see tests/test_lossy_fused.py's contract).

    Gates (ValueError otherwise): no subsampling, >= 1 decomposition
    level, uniform tile grid with tile dims divisible by sp * 2^levels
    and tile origins by 2^levels.  The reference's only parallelism is a
    goroutine pool over code-blocks (/root/reference/encoder.go:690-742);
    this is the device-mesh replacement spanning devices and hosts.
    """
    import numpy as np
    from ..models import encoder as enc
    from ..models import rate as rate_mod
    from ..options import default_options

    opts = opts or default_options()
    if opts.num_resolutions < 2:
        raise ValueError("encode_sharded: needs >= 1 decomposition level")
    image = np.asarray(image)
    comps = enc._image_components(image)
    header = enc.build_header(image, opts)
    precision = header.components[0].precision
    signed = header.components[0].signed
    n_comps = len(comps)
    enc._apply_comp_quants(header, opts, n_comps, precision)
    main = enc._write_main_header(header, opts, n_comps)

    from ..tcd import geometry as geo
    levels = header.coding_style.num_decompositions
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    T = header.num_tiles
    b0 = header.tile_bounds(0)
    th, tw = b0[3] - b0[1], b0[2] - b0[0]
    for t in range(T):
        tb = header.tile_bounds(t)
        if (tb[2] - tb[0], tb[3] - tb[1]) != (tw, th):
            raise ValueError("encode_sharded: uniform tile grid required")
        if (tb[0] % (1 << levels)) or (tb[1] % (1 << levels)):
            raise ValueError("encode_sharded: tile origins must be "
                             "divisible by 2^levels")
    if th % (sp * (1 << levels)):
        raise ValueError("encode_sharded: tile height must be divisible "
                         "by sp * 2^levels")
    for ci in header.components:
        if ci.dx != 1 or ci.dy != 1:
            raise ValueError("encode_sharded: no subsampling")

    # ---- tile batch [T, C, th, tw] (pad T to a dp multiple) ----
    tiles_np = []
    for t in range(T):
        tx0, ty0, tx1, ty1 = header.tile_bounds(t)
        tiles_np.append(np.stack(
            [c[ty0 - header.y_offset:ty1 - header.y_offset,
               tx0 - header.x_offset:tx1 - header.x_offset]
             for c in comps]))
    T_pad = -(-T // dp) * dp
    for _ in range(T_pad - T):
        tiles_np.append(tiles_np[-1])
    # ship the native narrow dtype: the device casts to int32 inside the
    # mesh step, halving (uint16) or quartering (uint8) the h2d bytes
    batch = np.stack(tiles_np)
    if batch.dtype not in (np.uint8, np.int8, np.uint16, np.int16):
        batch = batch.astype(np.int32)

    use_mct = bool(header.coding_style.mct) and n_comps >= 3
    kind = dwt.REV53 if header.coding_style.transform == 1 else dwt.IRR97
    step = make_tile_transform_step(mesh, levels, use_mct, precision,
                                    signed, kind)
    pyr, stats = step(batch)
    jax.block_until_ready(stats)
    from ..utils.metrics import counters
    counters.add("enc.sharded_transform_tiles", T)

    # ---- entropy: device HT kernel on the mesh-resident pyramid when
    # eligible (the flagship path — VERDICT r4 next #1), else per-dp-shard
    # host entropy (each shard = one "host"'s tiles) ----
    num_layers = header.coding_style.num_layers
    rate_budget = rate_mod.byte_budget(image, opts)
    per_shard = -(-T_pad // dp)

    shard_blocks = [[] for _ in range(dp)]
    shard_weights = [[] for _ in range(dp)]
    states = [None] * T
    cw_mct = enc.mct_comp_weights(header, opts.lossless, n_comps)
    dev_segs = _device_ht_entropy(header, opts, pyr, T, num_layers,
                                  rate_budget)
    if dev_segs is not None:
        from ..ops import t1
        for t in range(T):
            si = t // per_shard
            tile = geo.build_tile(header, t)
            enc_state, job_slots = enc._walk_geometry(tile)
            results = []
            for (seg, numbps, dist) in dev_segs[t]:
                if numbps == 0:
                    results.append(t1.T1EncodeResult(b"", 0, [], []))
                else:
                    # cleanup-only HT signaling (numbps = 1) — identical
                    # to the host coder's result shape, so PCRD/T2 see
                    # byte-identical inputs
                    p = t1.PassInfo(2, 0, len(seg), dist, True)
                    results.append(t1.T1EncodeResult(seg, 1, [p],
                                                     [len(seg)]))
            blocks, wts = enc._build_blocks(job_slots, results,
                                             num_layers, opts.lossless,
                                             cw_mct)
            shard_blocks[si] += blocks
            shard_weights[si] += wts
            states[t] = (tile, enc_state)
    else:
        leaves = [{k: np.asarray(v) for k, v in entry.items()}
                  for entry in pyr]
        for t in range(T):
            si = t // per_shard
            tile = geo.build_tile(header, t)
            pyramids = [{k: v[t] for k, v in entry.items()}
                        for entry in leaves]
            enc_state, job_slots, block_jobs = enc._entropy_jobs(
                tile, pyramids, lossless=opts.lossless)
            results = enc.encode_blocks_batch(
                block_jobs, backend=opts.backend,
                ht_refinement=(opts.high_throughput
                               and enc.effective_ht_refinement(opts)),
                ht_require_exact=opts.lossless,
                exact_rates=opts.exact_rates and (num_layers > 1
                                                  or rate_budget is not None))
            blocks, wts = enc._build_blocks(job_slots, results,
                                             num_layers, opts.lossless,
                                             cw_mct)
            shard_blocks[si] += blocks
            shard_weights[si] += wts
            states[t] = (tile, enc_state)

    # ---- distributed PCRD (mesh psum/pmax collectives) + Tier-2 ----
    comm = _mesh_comm(mesh)
    all_blocks = [b for sb in shard_blocks for b in sb]
    assign_fn = lambda target: rate_mod.assign_layers_sharded(
        shard_blocks, shard_weights, num_layers, target, allreduce=comm)
    tile_parts, ppm_chunks = enc._assemble_with_budget(
        header, opts, states, all_blocks, num_layers, rate_budget, main,
        assign_fn)
    return enc._finalize_codestream(header, opts, main, tile_parts,
                                    ppm_chunks, int(image.size))


@functools.lru_cache(maxsize=64)
def _shard_decode_fn(plan_key: int, n: int, n_comps: int, nl: int,
                     pool_cap: int, lossy: bool = False):
    """Jitted device half of the sharded HT decode for one tile-class
    group: MagSgn extraction at prefix-sum offsets + block->pyramid
    assembly (ops/ht_tpu_decode.py), returning stacked leaves
    [n, C, h, w] as a pytree.  lossy=True additionally applies the
    per-band midpoint dequantization on device (the leaves come out
    float32, ready for the sharded inverse 9/7)."""
    from ..models import fused_encode
    from ..ops import ht_tpu_decode
    plan = fused_encode._PLANS[plan_key]

    def fn(qinfo, pool, woff):
        blocks = ht_tpu_decode.magsgn_decode_blocks(
            qinfo, pool, woff, plan.cbh, plan.cbw)
        return ht_tpu_decode.blocks_to_pyramid_dev(
            blocks, plan, n, n_comps, nl, dequant=lossy)

    return jax.jit(fn)


def _device_ht_decode(header, parts_by_tile, codestream, T: int, config):
    """Device HT entropy for decode_sharded (the decode twin of
    _device_ht_entropy): native T2 + MEL/VLC control phase per tile
    (loader.ht_t2_parse_frames), device MagSgn extraction + pyramid
    assembly per tile-class, leaves kept ON DEVICE for the mesh inverse.

    Returns leaves (list of level dicts of [T, C, h, w] device arrays) or
    None when any tile needs the general host path."""
    from ..models import fused_encode
    from ..ops import dwt as dwt_mod
    from ..tcd import geometry as geo
    if config.reduce_resolution or config.decode_area is not None:
        return None
    if config.quality_layers not in (None, 0):
        return None
    cs = header.coding_style
    if cs.num_layers != 1 or header.ppm or cs.has_sop or cs.has_eph:
        return None
    if not header.is_htj2k:
        return None
    if any(t not in parts_by_tile for t in range(T)):
        return None   # absent tiles: host loop zero-fills
    from ..native import loader
    loader.require()
    levels = cs.num_decompositions
    n_comps = header.num_components
    lossy = cs.transform == 0

    groups: Dict[int, List[int]] = {}
    plans: Dict[int, object] = {}
    tiles: Dict[int, object] = {}
    for t in range(T):
        tile = geo.build_tile(header, t)
        if any(tp.packed_headers for tp in parts_by_tile[t]):
            return None
        plan = fused_encode.plan_for(header, tile, ht=True, multi_tile=True,
                                     lossy=lossy)
        if plan is None:
            return None
        k = fused_encode._plan_key(plan)
        groups.setdefault(k, []).append(t)
        plans[k] = plan
        tiles.setdefault(k, tile)

    per_tile = {}
    for k, tidx in groups.items():
        plan = plans[k]
        geom = fused_encode.t2_geom(header, tiles[k], plan)
        datas = [b"".join(codestream[tp.data_start:tp.data_end]
                          for tp in parts_by_tile[t]) for t in tidx]
        frame_off = np.zeros(len(datas) + 1, np.int64)
        np.cumsum([len(d) for d in datas], out=frame_off[1:])
        if int(frame_off[-1]) * 8 + 64 >= (1 << 31):
            return None   # magsgn bit offsets must fit int32
        buf = np.frombuffer(b"".join(datas), dtype=np.uint8)
        parsed = loader.ht_t2_parse_frames(
            buf, frame_off, len(tidx), plan.nb, geom, geom["mb"],
            plan.ws, plan.hs, plan.cbh, plan.cbw)
        if parsed is None:
            return None   # layered/truncated stream: general path
        qinfo, pool, woff, _nw, _numbps = parsed
        cap = 1 << 12
        while cap < len(pool):
            cap = int(cap * 3 // 2)
        pool = np.pad(pool, (0, cap - len(pool)))
        fn = _shard_decode_fn(k, len(tidx), n_comps, levels, cap, lossy)
        stacked = fn(jax.device_put(qinfo), jax.device_put(pool),
                     jax.device_put(woff.astype(np.int32)))
        for i, t in enumerate(tidx):
            per_tile[t] = (stacked, i)

    from ..utils.metrics import counters
    counters.add("dec.sharded_device_ht_tiles", T)
    # reassemble leaves in tile order (device-side stacks of slices)
    leaves = []
    nl_eff = max(1, levels)
    for lev in range(nl_eff):
        entry = {}
        ref_stacked, _ = per_tile[0]
        for band in ref_stacked[lev]:
            entry[band] = jnp.stack(
                [per_tile[t][0][lev][band][per_tile[t][1]]
                 for t in range(T)])
        leaves.append(entry)
    return leaves


@functools.lru_cache(maxsize=32)
def make_tile_inverse_step(mesh: Mesh, levels: int, use_mct: bool,
                           precision: int, signed: bool,
                           kind: str = dwt.REV53):
    """Jitted mesh-sharded inverse transform over a tile pyramid batch:
    leaves [T, C, h, w] (T over 'dp', rows over 'sp') -> samples
    [T, C, th, tw] int32.  Sharded IDWT with ppermute halo exchange +
    inverse RCT/ICT + DC shift + precision clamp (matching
    models/transforms.inverse_transform_batch — bit-for-bit on the
    reversible path; the irreversible 9/7 path takes dequantized float32
    leaves and rounds like the host inverse)."""
    from ..ops import mct

    def local_step(pyr):
        pyr = jax.tree_util.tree_map(
            lambda l: l.astype(jnp.int32 if kind == dwt.REV53
                               else jnp.float32), pyr)
        x = idwt_multilevel_sharded(pyr, "sp", kind)
        c = x.shape[1]
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
        return mct.clamp_to_precision(x, precision, signed)

    from jax import shard_map
    spec = P("dp", None, "sp", None)
    fn = shard_map(local_step, mesh=mesh, in_specs=(spec,), out_specs=spec,
                   check_vma=False)
    return jax.jit(fn)


def decode_sharded(data: bytes, mesh: Mesh, config=None):
    """Mesh-sharded decode: host Tier-2/Tier-1 per dp-shard, ONE sharded
    inverse-transform program over the mesh (rows over 'sp' with halo
    exchange), host tile assembly.  Reversible streams decode
    pixel-identical to models.decoder.decode; irreversible (9/7) streams
    match within +-1 sample value (float32 inverse-DWT ulps; see
    tests/test_sharded_pipeline.py).

    Gates (ValueError otherwise): no subsampling, >= 1 decomposition
    level, uniform tile grid meeting the same divisibility rules as
    encode_sharded.
    """
    import numpy as np
    from ..codestream.parser import Parser
    from ..models import decoder as dec
    from ..options import Config
    from ..tcd import geometry as geo

    config = config or Config()
    if config.reduce_resolution or config.decode_area is not None:
        # the mesh inverse reconstructs every tile at FULL resolution; a
        # reduced/windowed request would silently come back full-size
        # (the host tile loop returns pre-reduce pyramids) — route those
        # to models.decoder.decode, which skips the unneeded work
        raise ValueError("decode_sharded: full-resolution full-frame "
                         "decodes only (use models.decoder.decode for "
                         "reduce_resolution / decode_area)")
    fmt, codestream, jp2 = dec.sniff_format(data)
    parser = Parser(codestream)
    header = parser.read_header()
    tile_parts = parser.read_all_tile_parts(header)
    kind = dwt.REV53 if header.coding_style.transform == 1 else dwt.IRR97
    levels = header.coding_style.num_decompositions
    if levels < 1:
        raise ValueError("decode_sharded: needs >= 1 decomposition level")
    for ci in header.components:
        if ci.dx != 1 or ci.dy != 1:
            raise ValueError("decode_sharded: no subsampling")
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    T = header.num_tiles
    b0 = header.tile_bounds(0)
    tw, th = b0[2] - b0[0], b0[3] - b0[1]
    for t in range(T):
        tb = header.tile_bounds(t)
        if (tb[2] - tb[0], tb[3] - tb[1]) != (tw, th):
            raise ValueError("decode_sharded: uniform tile grid required")
        if (tb[0] % (1 << levels)) or (tb[1] % (1 << levels)):
            raise ValueError("decode_sharded: tile origins must be "
                             "divisible by 2^levels")
    if th % (sp * (1 << levels)):
        raise ValueError("decode_sharded: tile height must be divisible "
                         "by sp * 2^levels")

    parts_by_tile = {}
    for tp in tile_parts:
        parts_by_tile.setdefault(tp.tile_index, []).append(tp)

    # ---- entropy: device HT kernel when eligible (the decode twin of
    # encode_sharded's _device_ht_entropy — leaves stay on device), else
    # host entropy per tile (per-dp-shard work), pyramids kept ----
    n_comps = header.num_components
    precision = header.components[0].precision
    signed = header.components[0].signed
    use_mct = bool(header.coding_style.mct) and n_comps >= 3
    if not parts_by_tile:
        raise dec.DecodeError("decode_sharded: codestream has no tile-parts")
    leaves = _device_ht_decode(header, parts_by_tile, codestream, T, config)
    for t in ([] if leaves is not None else range(T)):
        if t not in parts_by_tile:
            continue   # tile absent from the stream: area stays zero-filled
                       # (matches _decode_tiles; ADVICE r4 #4)
        tile = geo.build_tile(header, t)
        comp_pyr, comp_lls, _meta = dec._decode_tile(
            header, tile, parts_by_tile[t], codestream, config,
            _return_pyramids=True)
        if leaves is None:
            # lossy host pyramids carry DEQUANTIZED float32 coefficients
            # (decoder._decode_tile midpoint reconstruction)
            leaf_dt = np.int32 if kind == dwt.REV53 else np.float32
            leaves = []
            for lev in range(levels):
                entry = {}
                for k in comp_pyr[0][lev]:
                    hh, ww = comp_pyr[0][lev][k].shape
                    entry[k] = np.zeros((T, n_comps, hh, ww), leaf_dt)
                if lev == levels - 1:
                    entry["LL"] = np.zeros(
                        (T, n_comps) + comp_lls[0].shape, leaf_dt)
                leaves.append(entry)
        for c in range(n_comps):
            for lev in range(levels):
                for k in comp_pyr[c][lev]:
                    leaves[lev][k][t, c] = comp_pyr[c][lev][k]
            leaves[levels - 1]["LL"][t, c] = comp_lls[c]

    if leaves is None:
        raise dec.DecodeError("decode_sharded: no tile-part belongs to any "
                              "in-range tile index")
    T_pad = -(-T // dp) * dp
    if T_pad != T:
        leaves = [{k: jnp.concatenate(
            [v, jnp.repeat(v[-1:], T_pad - T, axis=0)])
            for k, v in e.items()} for e in leaves]

    # ---- mesh inverse transform ----
    step = make_tile_inverse_step(mesh, levels, use_mct, precision,
                                  signed, kind)
    out = np.asarray(step(leaves))[:T]
    from ..utils.metrics import counters
    counters.add("dec.sharded_transform_tiles", T)

    # ---- tile assembly (decoder output conventions) ----
    if precision <= 8:
        dt = np.int8 if signed else np.uint8
    elif precision <= 16:
        dt = np.int16 if signed else np.uint16
    else:
        dt = np.int32
    out_h = header.height - header.y_offset
    out_w = header.width - header.x_offset
    planes = np.zeros((n_comps, out_h, out_w), np.int32)
    for t in range(T):
        if t not in parts_by_tile:
            continue   # absent tile: pixel area stays zero (ADVICE r4 #4)
        tx0, ty0, tx1, ty1 = header.tile_bounds(t)
        planes[:, ty0 - header.y_offset:ty1 - header.y_offset,
               tx0 - header.x_offset:tx1 - header.x_offset] = out[t]
    img = planes[0] if n_comps == 1 else np.moveaxis(planes, 0, -1)
    return img.astype(dt)


def make_encode_step(mesh: Mesh, levels: int = 3, precision: int = 8):
    """Jitted, mesh-sharded forward encode step (the 'training step' analog).

    Input: uint8/int32 batch [B, H, W, C] with B % dp == 0 and
    H % (sp * 2^levels) == 0.  Runs DC shift + RCT + sharded multi-level 5/3
    DWT + per-band significance/rate statistics with a psum allreduce.
    Returns (subband pyramid pytree, rate_stats).
    """
    from ..ops import mct
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]

    def local_step(batch):
        # batch local shard: [B/dp, H/sp, W, C]
        x = batch.astype(jnp.int32) - (1 << (precision - 1))
        if x.shape[-1] >= 3:
            y, u, v = mct.forward_rct(x[..., 0], x[..., 1], x[..., 2])
            planes = [y, u, v] + [x[..., i] for i in range(3, x.shape[-1])]
        else:
            planes = [x[..., i] for i in range(x.shape[-1])]
        comp = jnp.stack(planes, axis=1)      # [B/dp, C, H/sp, W]
        pyr = dwt53_multilevel_sharded(comp, levels, "sp")
        # rate-allocation stats: total |coeff| energy and significant-sample
        # count per level, allreduced over the whole mesh (PCRD psum).
        stats = []
        for entry in pyr:
            for k in ("HL", "LH", "HH"):
                a = entry[k]
                stats.append(jnp.stack([
                    jnp.sum(jnp.abs(a).astype(jnp.float32)),
                    jnp.sum((a != 0).astype(jnp.float32)),
                ]))
        stats = jnp.stack(stats)
        stats = jax.lax.psum(stats, "sp")
        stats = jax.lax.psum(stats, "dp")
        return pyr, stats

    from jax import shard_map
    in_spec = P("dp", "sp", None, None)
    # pyramid leaves: [B/dp, C, H/sp /2^k, W/2^k] -> batch over dp, rows over sp
    out_spec = (P("dp", None, "sp", None), P())
    fn = shard_map(local_step, mesh=mesh, in_specs=(in_spec,),
                   out_specs=out_spec, check_vma=False)
    return jax.jit(fn)
