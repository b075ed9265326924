#!/usr/bin/env python
"""Sub-stage timing of the fused HT encode device program: which of
transform / field math / VLC table gather / bit-pack scan+sort / pool
compaction takes the time — measured as deltas between progressively
longer jitted prefixes of the same program, each synced with a 1-element
readback.
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
    from go_jpeg2000_tpu.models import fused_encode
    from go_jpeg2000_tpu.models.encoder import build_header, _image_components
    from go_jpeg2000_tpu.ops import dwt, ht_tpu
    from go_jpeg2000_tpu.options import Format, Options
    from go_jpeg2000_tpu.tcd import geometry as geo

    H = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    frames = [natural_image(H, H, seed=i) for i in range(N)]
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=6,
                   high_throughput=True)
    header = build_header(frames[0], opts)
    tile = geo.build_tile(header, 0)
    plan = fused_encode.plan_for(header, tile)
    batch = np.stack([np.stack(_image_components(im)) for im in frames])
    n, c, h, w = batch.shape
    caps = fused_encode._caps_for(plan, n)
    cap_ms, cap_vlc, cap_mel = caps
    hs = np.tile(plan.hs, n)
    ws = np.tile(plan.ws, n)
    flat = jax.device_put(np.ascontiguousarray(batch).reshape(-1))
    px = n * h * w

    def blocks_of(bf):
        x = bf.reshape(n, c, h, w).astype(jnp.int32) - 128
        pyr = dwt.decompose(x, 5, dwt.REV53)
        return fused_encode._extract_blocks(pyr, plan, n, 5)

    def sync(x):
        return np.asarray(x.reshape(-1)[:1])

    def timeit(f, iters=8):
        out = f()
        sync(out if not isinstance(out, (tuple, list, dict)) else
             jax.tree_util.tree_leaves(out)[0])
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f()
        sync(out if not isinstance(out, (tuple, list, dict)) else
             jax.tree_util.tree_leaves(out)[0])
        return (time.perf_counter() - t0) / iters

    stages = {}

    f_transform = jax.jit(lambda bf: blocks_of(bf))
    stages["transform+extract"] = timeit(lambda: f_transform(flat))

    def fields_no_pack(bf):
        """cleanup_fields with the three _pack_bits calls replaced by cheap
        reductions: isolates the field math + table gathers."""
        blocks = blocks_of(bf)
        import go_jpeg2000_tpu.ops.ht_tpu as m
        orig = m._pack_bits
        try:
            def stub(vals, lens, n_words):
                nbb = vals.shape[0]
                total = jnp.sum(lens, axis=1).astype(jnp.int32)
                return (jnp.zeros((nbb, 1), jnp.uint32)
                        + jnp.sum(vals, axis=1, keepdims=True)), total
            m._pack_bits = stub
            out = m.cleanup_fields(blocks, hs, ws, plan.max_mn)
        finally:
            m._pack_bits = orig
        return out["ms_bits"] + out["vlc_bits"]

    f_nopack = jax.jit(fields_no_pack)
    stages["+fields(no pack)"] = timeit(lambda: f_nopack(flat))

    f_fields = jax.jit(lambda bf: ht_tpu.cleanup_fields(
        blocks_of(bf), hs, ws, plan.max_mn))
    stages["+fields+pack"] = timeit(lambda: f_fields(flat)["ms_words"])

    f_full = jax.jit(lambda bf: ht_tpu.cleanup_fields_compact(
        blocks_of(bf), hs, ws, plan.max_mn, *caps))
    stages["full(+pool compact)"] = timeit(lambda: f_full(flat))

    print(f"{n}x{h}x{w} ({px/1e6:.2f} Mpix), nb={plan.nb}/frame, "
          f"caps {caps}")
    prev = 0.0
    for k, v in stages.items():
        print(f"{k:24s} {v*1e3:8.2f} ms  (delta {(v-prev)*1e3:7.2f} ms)  "
              f"{px/v/1e6:7.1f} Mpix/s")
        prev = v

    # --- algorithm-variant sweep ---
    import jax as _jax
    for pi in ("base", "paired"):
        ht_tpu.PACK_IMPL = pi
        fv = _jax.jit(lambda bf: ht_tpu.cleanup_fields_compact(
            blocks_of(bf), hs, ws, plan.max_mn, *caps))
        t = timeit(lambda: fv(flat))
        print(f"variant pack_impl={pi:7s} "
              f"{t*1e3:8.2f} ms  {px/t/1e6:7.1f} Mpix/s")
    ht_tpu.PACK_IMPL = "paired"


if __name__ == "__main__":
    main()
