#!/usr/bin/env python
"""Device measurements behind the GPU bring-up's choices.

1. Plain-XLA DWT (ops/dwt.py): time jitted `decompose` and `reconstruct`,
   5 levels, 5/3 int32 and 9/7 float32, at 2048^2 x 3 components and at
   32 x 512^2.  Each level must at least read its input and write its four
   subbands once (2 x 4 bytes per sample of that level), so the least
   traffic is 8 * samples * sum_l 4^-l bytes; the share of HBM bandwidth
   is that over the measured time, against the H100's published 3.35 TB/s
   and against a large device copy timed in the same process.
2. Device->host fetch of the fused HT encode's stream pools at
   ht_lossless_2048 (2 frames of 2048^2): one async copy per pool slice
   (utils/fetch.py) against the same slices split eight ways, each part
   copied on its own.  Runs alternate; medians and quartiles are printed.
3. EBCOT encode of 8 x 512^2 lossless frames through device path A,
   hybrid path B and host path C, in rotating order (the choice behind
   models/encoder.AUTO_EBCOT_PATH).

Prints one JSON object per measurement, then the card.  Exits non-zero
without a GPU.

Usage: python tools/gpu_findings.py [dwt] [fetch] [ebcot]   (default: all)
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}   # NVIDIA data sheet, SXM


def _time(fn, reps):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return np.percentile(ts, [25, 50, 75])


def copy_bandwidth(n=1 << 28, reps=20):
    import jax
    import jax.numpy as jnp
    x = jnp.ones((n,), jnp.int32)                       # 1 GiB
    bump = jax.jit(lambda a: a + 1)
    q = _time(lambda: bump(x), reps)
    return 2 * x.nbytes / q[1]


DWT_SHAPES = (("2048x2048x3", (3, 2048, 2048)),
              ("32x512x512", (32, 512, 512)))


def dwt_timings(shapes=DWT_SHAPES, reps=20):
    import jax
    import jax.numpy as jnp
    from go_jpeg2000_tpu.ops import dwt
    levels = 5
    rows = []
    for label, shape in shapes:
        for kind, dt in ((dwt.REV53, jnp.int32), (dwt.IRR97, jnp.float32)):
            rng = np.random.RandomState(0)
            x = jnp.asarray(rng.randint(-128, 128, size=shape), dt)
            fwd = jax.jit(lambda a, k=kind: dwt.decompose(a, levels, k))
            pyr = fwd(x)
            inv = jax.jit(lambda p, k=kind: dwt.reconstruct(p, k))
            samples = float(np.prod(shape))
            least = 8 * samples * sum(4.0 ** -l for l in range(levels))
            for name, fn in (("decompose", lambda: fwd(x)),
                             ("reconstruct", lambda: inv(pyr))):
                q = _time(fn, reps)
                rows.append({"op": name, "shape": label, "kind": kind,
                             "ms_p25_p50_p75": [v * 1e3 for v in q],
                             "least_bytes": least,
                             "bytes_per_s": least / q[1]})
    return rows


def fetch_timings(size=2048, reps=15):
    import jax
    from go_jpeg2000_tpu.models import fused_encode
    from go_jpeg2000_tpu.models.encoder import (build_header,
                                                _image_components)
    from go_jpeg2000_tpu.options import Format, Options
    from go_jpeg2000_tpu.tcd import geometry as geo
    from go_jpeg2000_tpu.utils import fetch
    import chip_smoke

    frames = [chip_smoke.natural_image(size, size, seed=i) for i in range(2)]
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=6,
                   high_throughput=True)
    header = build_header(frames[0], opts)
    tile = geo.build_tile(header, 0)
    plan = fused_encode.plan_for(header, tile)
    batch = np.stack([np.stack(_image_components(im)) for im in frames])
    for _ in range(3):                    # settle the adaptive caps
        d = fused_encode.dispatch(batch, 5, False, 8, False, plan)
        if fused_encode._gather_pools(d)[1] is None:
            fused_encode._grow_caps(plan, d)

    def slices():
        d = fused_encode.dispatch(batch, 5, False, 8, False, plan)
        out, meta_fetch = d.out
        meta = fetch.gather(meta_fetch).view(np.int32).reshape(6, -1)
        nmeta = meta.size
        cap_ms, cap_vlc, cap_mel = d.caps
        used = [int(((meta[i].astype(np.int64) + 31) >> 5).sum())
                for i in range(3)]
        bases = [nmeta, nmeta + cap_ms, nmeta + cap_ms + cap_vlc]
        parts = [fused_encode._slice_fn(b, fused_encode._bucket_words(u, c))(
            out) for b, u, c in zip(bases, used, (cap_ms, cap_vlc, cap_mel))]
        jax.block_until_ready(parts)
        return parts

    def one_copy(parts):
        return [fetch.gather(fetch.fetch_async(p)) for p in parts]

    split_fns = {}

    def eight_way(parts):
        out = []
        for p in parts:
            n = int(p.size)
            if n not in split_fns:
                step = -(-n // 8)
                bounds = [(i * step, min(n, (i + 1) * step))
                          for i in range(8) if i * step < n]
                split_fns[n] = jax.jit(lambda x, b=tuple(bounds): tuple(
                    jax.lax.slice_in_dim(x, s, e) for s, e in b))
            pieces = split_fns[n](p)
            for q in pieces:
                q.copy_to_host_async()
            out.append(np.concatenate([np.asarray(q) for q in pieces]))
        return out

    ref = one_copy(slices())
    assert all(np.array_equal(a, b) for a, b in zip(ref,
                                                    eight_way(slices())))
    ts = {"one_copy": [], "eight_way": []}
    nbytes = sum(int(p.nbytes) for p in slices())
    for i in range(2 * reps):
        name = ("one_copy", "eight_way", "eight_way", "one_copy")[i % 4]
        parts = slices()
        t0 = time.perf_counter()
        (one_copy if name == "one_copy" else eight_way)(parts)
        ts[name].append(time.perf_counter() - t0)
    return {"pool_bytes": nbytes,
            **{k: [v * 1e3 for v in np.percentile(t, [25, 50, 75])]
               for k, t in ts.items()}}


def ebcot_paths(size=512, n=8, reps=10):
    """encode_batch of n size^2 frames, EBCOT lossless, through path A
    (backend="device"), B ("hybrid") and C ("native": device transform +
    host C++ T1), in rotating order; medians and quartiles in ms."""
    from go_jpeg2000_tpu.models.encoder import encode_batch
    from go_jpeg2000_tpu.options import Format, Options
    import chip_smoke

    frames = [chip_smoke.natural_image(size, size, seed=i) for i in range(n)]
    paths = {"A_device": "device", "B_hybrid": "hybrid", "C_host": "native"}
    opts = {k: Options(format=Format.J2K, lossless=True, num_resolutions=6,
                       high_throughput=False, backend=v)
            for k, v in paths.items()}
    ref = None
    for k in paths:                               # compile, settle caps
        for _ in range(2):
            out = encode_batch(frames, opts[k])
        assert ref is None or out == ref, f"{k} bytes differ"
        ref = out
    ts = {k: [] for k in paths}
    order = list(paths)
    for r in range(reps):
        for k in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            encode_batch(frames, opts[k])
            ts[k].append(time.perf_counter() - t0)
    px = n * size * size
    return {k: {"ms_p25_p50_p75": [v * 1e3 for v in
                                   np.percentile(t, [25, 50, 75])],
                "mpix_s_median": px / float(np.median(t)) / 1e6}
            for k, t in ts.items()}


def main():
    from go_jpeg2000_tpu.utils import device_info
    dev = device_info.require_gpu()
    gpu = device_info.nvidia_smi()
    peak = HBM_PEAK.get(dev["kind"])
    sections = sys.argv[1:] or ["dwt", "fetch", "ebcot"]
    if "dwt" in sections:
        copy = copy_bandwidth()
        print(json.dumps({"copy_bytes_per_s": copy, "hbm_peak": peak}),
              flush=True)
        for row in dwt_timings():
            row["share_of_peak"] = (row["bytes_per_s"] / peak if peak
                                    else None)
            row["share_of_copy"] = row["bytes_per_s"] / copy
            print(json.dumps(row), flush=True)
    if "fetch" in sections:
        print(json.dumps({"fetch_ht_lossless_2048_ms": fetch_timings()}),
              flush=True)
    if "ebcot" in sections:
        print(json.dumps({"ebcot53_512_encode": ebcot_paths()}), flush=True)
    print(f"gpu: {gpu}")
    print(json.dumps({"device": dev}))
    if peak is None:
        raise SystemExit(f"no HBM peak on record for {dev['kind']}")


if __name__ == "__main__":
    main()
