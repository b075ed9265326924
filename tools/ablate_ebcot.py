#!/usr/bin/env python
"""EBCOT path ablation: measure, on the GPU,

  A. all-device: decision kernel + lockstep MQ + pool compaction
     (models/ebcot_fused.py, the r4 clz-renorm kernel)
  B. hybrid: device decision kernel only -> fetch packed decision streams
     -> native host MQ over the streams (loader.mq_encode_streams)
  C. host: device transform -> fetch coefficients -> native C++ full T1

Reports device/compute/fetch/host wall times and Mpix/s per path.
Segment byte-equality across
all three paths is asserted (same decisions -> same MQ bytes).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def natural_image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=(h, w)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def main():
    import jax
    import jax.numpy as jnp
    from go_jpeg2000_tpu.models import ebcot_fused, fused_encode
    from go_jpeg2000_tpu.models.encoder import build_header, _image_components
    from go_jpeg2000_tpu.native import loader
    from go_jpeg2000_tpu.ops import dwt, ebcot_device, mq_device
    from go_jpeg2000_tpu.options import Format, Options
    from go_jpeg2000_tpu.tcd import geometry as geo

    n_frames = 4
    frames = [natural_image(512, 512, seed=i) for i in range(n_frames)]
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=6,
                   high_throughput=False)
    header = build_header(frames[0], opts)
    tile = geo.build_tile(header, 0)
    plan = ebcot_fused.plan_for(header, tile)
    assert plan is not None
    batch = np.stack([np.stack(_image_components(im)) for im in frames])
    n, c, h, w = batch.shape
    px = n * h * w
    precision = header.components[0].precision
    max_planes = plan.max_mn - 2
    t_cap, cap_pool = ebcot_fused._caps_for(plan, n)
    flat = jax.device_put(np.ascontiguousarray(batch).reshape(-1))

    def sync(x):
        return np.asarray(x.reshape(-1)[:1])

    def timeit(f, rep=3):
        f()
        t0 = time.perf_counter()
        for _ in range(rep):
            out = f()
        dt = (time.perf_counter() - t0) / rep
        return out, dt

    print(f"platform: {jax.devices()[0].platform}; {n}x{h}x{w} frames, "
          f"{plan.nb} blocks/frame, t_cap {t_cap}")

    # ---------- A: all-device ----------
    fn_a = ebcot_fused._ebcot_fn(n, c, h, w, 5, False, precision, False,
                                 ebcot_fused._plan_key(plan), max_planes,
                                 t_cap, cap_pool)
    def run_a():
        meta, pool = fn_a(flat)
        sync(meta)
        return meta, pool
    (meta_a, pool_a), dt_a = timeit(run_a)
    t0 = time.perf_counter()
    meta_np = np.asarray(meta_a)
    pool_np = np.asarray(pool_a)
    t_fetch_a = time.perf_counter() - t0
    lens = meta_np[0]
    ends = np.cumsum(lens); offs = ends - lens
    segs_a = []
    for i in range(len(lens)):
        seg = bytes(pool_np[offs[i]:ends[i]])
        if seg and seg[-1] == 0xFF:
            seg = seg[:-1]
        segs_a.append(seg)
    print(f"A all-device:      compute {dt_a*1e3:7.1f} ms "
          f"({px/dt_a/1e6:6.1f} Mpix/s) + fetch {t_fetch_a*1e3:.0f} ms "
          f"({pool_np.nbytes/1e6:.1f} MB)")

    # ---------- B: device decisions + host MQ ----------
    hs_t = np.tile(plan.hs, n); ws_t = np.tile(plan.ws, n)
    bclass = np.tile(plan.bclass, n)

    @jax.jit
    def fn_b(bf):
        x = bf.reshape(n, c, h, w).astype(jnp.int32) - 128
        pyr = dwt.decompose(x, 5, dwt.REV53)
        blocks = fused_encode._extract_blocks(pyr, plan, n, 5)
        B = n * plan.nb
        mags = jnp.abs(blocks)
        signs = (blocks < 0).astype(jnp.int32)
        yy = jax.lax.broadcasted_iota(jnp.int32, (B, plan.cbh, plan.cbw), 1)
        xx = jax.lax.broadcasted_iota(jnp.int32, (B, plan.cbh, plan.cbw), 2)
        valid = (yy < hs_t[:, None, None]) & (xx < ws_t[:, None, None])
        slots = ebcot_device.decision_slots(
            mags, signs, jnp.asarray(bclass), valid, max_planes)
        sv = slots != ebcot_device.EMPTY
        ndec = jnp.sum(sv, axis=1).astype(jnp.int32)
        aligned = mq_device.compact_rows(slots, sv, t_cap)
        return aligned, ndec

    def run_b_dev():
        a, nd = fn_b(flat)
        sync(nd)
        return a, nd
    (aligned, ndec_d), dt_b_dev = timeit(run_b_dev)
    t0 = time.perf_counter()
    aligned_np = np.asarray(aligned)
    ndec_np = np.asarray(ndec_d)
    t_fetch_b = time.perf_counter() - t0
    streams = [bytes(aligned_np[i, :ndec_np[i]].astype(np.uint8))
               for i in range(aligned_np.shape[0])]
    t0 = time.perf_counter()
    segs_b = loader.mq_encode_streams(streams)
    t_host_b = time.perf_counter() - t0
    print(f"B hybrid:          compute {dt_b_dev*1e3:7.1f} ms "
          f"({px/dt_b_dev/1e6:6.1f} Mpix/s) + fetch {t_fetch_b*1e3:.0f} ms "
          f"({aligned_np.nbytes/1e6:.1f} MB decisions) + host MQ "
          f"{t_host_b*1e3:.0f} ms ({px/t_host_b/1e6:.1f} Mpix/s)")

    assert [s for s in segs_b] == [s for s in segs_a], \
        "hybrid MQ bytes differ from all-device"

    # ---------- C: device transform + host C++ full T1 ----------
    @jax.jit
    def fn_c(bf):
        x = bf.reshape(n, c, h, w).astype(jnp.int32) - 128
        pyr = dwt.decompose(x, 5, dwt.REV53)
        return fused_encode._extract_blocks(pyr, plan, n, 5).astype(jnp.int16)

    def run_c_dev():
        bl = fn_c(flat)
        sync(bl)
        return bl
    blocks_d, dt_c_dev = timeit(run_c_dev)
    t0 = time.perf_counter()
    blocks_np = np.asarray(blocks_d).astype(np.int32)
    t_fetch_c = time.perf_counter() - t0
    band_of = {0: "LL", 1: "HL", 2: "HH"}   # plan.bclass -> ZC class name
    jobs = []
    for i in range(blocks_np.shape[0]):
        bi = i % plan.nb
        jobs.append((blocks_np[i, :plan.hs[bi], :plan.ws[bi]],
                     band_of[int(plan.bclass[bi])],
                     0x100))     # STY_FAST_RATES
    t0 = time.perf_counter()
    res_c = loader.encode_blocks(jobs)
    t_host_c = time.perf_counter() - t0
    print(f"C host C++ T1:     transform {dt_c_dev*1e3:7.1f} ms + fetch "
          f"{t_fetch_c*1e3:.0f} ms ({blocks_np.nbytes//2/1e6:.1f} MB int16) "
          f"+ host T1 {t_host_c*1e3:.0f} ms ({px/t_host_c/1e6:.1f} Mpix/s)")
    # sanity: same segments (single MQ segment per block, default style)
    mismatch = sum(1 for r, s in zip(res_c, segs_a) if r.data != s)
    print(f"C vs A segment mismatches: {mismatch} (expect 0)")

    tot_a = dt_a + t_fetch_a
    tot_b = dt_b_dev + t_fetch_b + t_host_b
    tot_c = dt_c_dev + t_fetch_c + t_host_c
    print(f"totals: A {px/tot_a/1e6:.1f}  B {px/tot_b/1e6:.1f}  "
          f"C {px/tot_c/1e6:.1f} Mpix/s (encode side only)")


if __name__ == "__main__":
    main()
