#!/usr/bin/env python
"""Stage-time table for the encode/decode pipelines.

Measures, on the GPU, for the bench configs the per-stage wall time: h2d
upload, device compute, d2h fetch (with bytes), host serialize + T2, host
parse + entropy decode.  Exits non-zero when JAX finds no GPU.

Usage: python tools/profile_table.py [--out FILE]
Writes a markdown table to stdout and optionally to a file.
"""
from __future__ import annotations

import argparse
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


class Acc:
    def __init__(self):
        self.t = {}
        self.b = {}

    def add(self, name, dt, nbytes=None):
        self.t[name] = self.t.get(name, 0.0) + dt
        if nbytes is not None:
            self.b[name] = self.b.get(name, 0) + nbytes


def profile_ht(frames, iters=3):
    """HT fused path: stage-split encode + decode of `frames`."""
    import jax
    from go_jpeg2000_tpu.models import fused_encode, transforms
    from go_jpeg2000_tpu.models.encoder import (build_header, encode_batch,
                                                _chunk_frames,
                                                _image_components)
    from go_jpeg2000_tpu.models.decoder import (decode_batch, sniff_format,
                                                _blocks_to_pyramid)
    from go_jpeg2000_tpu.codestream.parser import Parser
    from go_jpeg2000_tpu.options import Format, Options
    from go_jpeg2000_tpu.tcd import geometry as geo
    from go_jpeg2000_tpu.native import loader
    from go_jpeg2000_tpu.ops import dwt, ht_tpu
    from go_jpeg2000_tpu.utils import fetch

    opts = Options(format=Format.J2K, lossless=True, num_resolutions=6,
                   high_throughput=True, backend="auto")
    # warm-up end to end (compiles everything)
    outs = encode_batch(frames, opts)
    decs = decode_batch(outs)
    assert np.array_equal(decs[0], frames[0])

    header = build_header(frames[0], opts)
    tile = geo.build_tile(header, 0)
    plan = fused_encode.plan_for(header, tile)
    assert plan is not None
    precision = header.components[0].precision
    nl0 = tile.comps[0].coding.num_decompositions
    n_frames = len(frames)
    batch = np.stack([np.stack(_image_components(im)) for im in frames])
    chunk = _chunk_frames(n_frames, int(np.prod(batch.shape[1:])))

    acc = Acc()
    for _ in range(iters):
        for s in range(0, n_frames, chunk):
            sub = batch[s:s + chunk]
            n, c, h, w = sub.shape
            caps = fused_encode._caps_for(plan, n)
            fn = fused_encode._fused_fn(
                n, c, h, w, nl0, False, precision, False,
                fused_encode._plan_key(plan), *caps)
            flat = np.ascontiguousarray(sub).reshape(-1)
            t0 = time.perf_counter()
            fd = jax.device_put(flat)
            fd.block_until_ready()
            t1 = time.perf_counter()
            acc.add("enc.h2d", t1 - t0, flat.nbytes)
            out = fn(fd)
            np.asarray(out.reshape(-1)[:1])     # sync (block_until_ready
                                                # returns early here)
            t2 = time.perf_counter()
            acc.add("enc.device", t2 - t1)
            nmeta = 6 * plan.nb * n
            meta_fetch = fetch.fetch_async(
                fused_encode._slice_fn(0, nmeta)(out))
            d = fused_encode.FusedDispatch((out, meta_fetch), n, plan, caps)
            meta, pool = fused_encode._gather_pools(d)
            assert pool is not None
            t3 = time.perf_counter()
            acc.add("enc.d2h", t3 - t2, pool.nbytes + meta.nbytes)
            d2 = fused_encode.FusedDispatch((out, meta_fetch), n, plan, caps)
            bodies = fused_encode.fetch_bodies(d2, header, tile)
            assert bodies is not None
            t4 = time.perf_counter()
            acc.add("enc.host_t2", t4 - t3)

    # ---- decode stages ----
    parsed = []
    for s_ in outs:
        fmt, codestream, jp2 = sniff_format(s_)
        parser = Parser(codestream)
        hdr = parser.read_header()
        tile_parts = parser.read_all_tile_parts(hdr)
        parsed.append((hdr, tile_parts, codestream, jp2))
    geom = fused_encode.t2_geom(header, tile, plan)
    n_comps = header.num_components
    for _ in range(iters):
        for s in range(0, n_frames, chunk):
            group = parsed[s:s + chunk]
            t0 = time.perf_counter()
            datas = [b"".join(cs_[tp.data_start:tp.data_end]
                              for tp in tps) for _h, tps, cs_, _j in group]
            frame_off = np.zeros(len(group) + 1, np.int64)
            np.cumsum([len(dd) for dd in datas], out=frame_off[1:])
            buf = np.frombuffer(b"".join(datas), dtype=np.uint8)
            coeffs = loader.ht_t2_decode_frames(
                buf, frame_off, len(group), plan.nb, geom,
                geom["mb"], plan.ws, plan.hs, plan.cbh, plan.cbw)
            t1 = time.perf_counter()
            acc.add("dec.host_t2+t1", t1 - t0)
            stacked = _blocks_to_pyramid(coeffs, plan, len(group),
                                         n_comps, nl0)
            t2 = time.perf_counter()
            acc.add("dec.host_reasm", t2 - t1)
            dev = transforms.dispatch_inverse_stacked(
                stacked, len(group), n_comps, max(1, nl0), dwt.REV53,
                False, precision, False, 0, 0)
            for p in dev:
                p.block_until_ready()
            t3 = time.perf_counter()
            acc.add("dec.h2d+device", t3 - t2)
            raw = fetch.gather(dev)
            t4 = time.perf_counter()
            acc.add("dec.d2h", t4 - t3, raw.nbytes)
    pixels = sum(f.size for f in frames)
    return acc, pixels, iters


def profile_ebcot(frames, iters=3):
    """Device-EBCOT path stage split (encode only; decode is host C++)."""
    import jax
    from go_jpeg2000_tpu.models import ebcot_fused
    from go_jpeg2000_tpu.models.encoder import (build_header, encode_batch,
                                                _chunk_frames,
                                                _image_components,
                                                _walk_geometry,
                                                _assemble_packets)
    from go_jpeg2000_tpu.models.decoder import decode_batch
    from go_jpeg2000_tpu.options import Format, Options
    from go_jpeg2000_tpu.tcd import geometry as geo
    from go_jpeg2000_tpu.utils import fetch

    opts = Options(format=Format.J2K, lossless=True, num_resolutions=6,
                   high_throughput=False, backend="auto")
    outs = encode_batch(frames, opts)
    decs = decode_batch(outs)
    assert np.array_equal(decs[0], frames[0])

    header = build_header(frames[0], opts)
    tile = geo.build_tile(header, 0)
    try:
        eplan = ebcot_fused.plan_for(header, tile)
    except Exception:
        eplan = None
    acc = Acc()
    n_frames = len(frames)
    batch = np.stack([np.stack(_image_components(im)) for im in frames])
    precision = header.components[0].precision
    nl0 = tile.comps[0].coding.num_decompositions
    if eplan is None:
        return acc, sum(f.size for f in frames), iters
    chunk = _chunk_frames(n_frames, int(np.prod(batch.shape[1:])))
    max_planes = min(24, eplan.max_mn - 2)
    for _ in range(iters):
        for s in range(0, n_frames, chunk):
            sub = batch[s:s + chunk]
            t0 = time.perf_counter()
            d = ebcot_fused.dispatch(sub, nl0, False, precision, False,
                                     eplan, max_planes)
            meta_dev, pool_fetch = d.out
            meta_dev.block_until_ready()
            for p in pool_fetch:
                if hasattr(p, "block_until_ready"):
                    p.block_until_ready()
            t1 = time.perf_counter()
            acc.add("enc.h2d+device", t1 - t0)
            results = ebcot_fused.fetch_results(d)
            assert results is not None
            t2 = time.perf_counter()
            acc.add("enc.d2h+host_mq", t2 - t1)
            nb = eplan.nb
            for i in range(len(results) // nb):
                enc_state, job_slots = _walk_geometry(tile)
                _assemble_packets(header, tile, enc_state, job_slots,
                                  results[i * nb:(i + 1) * nb], 0, opts,
                                  1, None)
            t3 = time.perf_counter()
            acc.add("enc.host_t2", t3 - t2)
    return acc, sum(f.size for f in frames), iters


def fmt_table(title, acc: Acc, pixels, iters):
    lines = [f"### {title}", "",
             "| stage | ms/iter | MB/iter | Mpix/s |", "|---|---|---|---|"]
    for k in acc.t:
        ms = acc.t[k] * 1e3 / iters
        mb = acc.b.get(k, 0) / iters / 1e6
        mpix = pixels / (acc.t[k] / iters) / 1e6
        mbs = f"{mb:.2f}" if k in acc.b else ""
        lines.append(f"| {k} | {ms:.1f} | {mbs} | {mpix:.1f} |")
    tot_e = sum(v for k, v in acc.t.items() if k.startswith("enc."))
    tot_d = sum(v for k, v in acc.t.items() if k.startswith("dec."))
    if tot_e:
        lines.append(f"| **enc total** | {tot_e * 1e3 / iters:.1f} | | "
                     f"{pixels / (tot_e / iters) / 1e6:.1f} |")
    if tot_d:
        lines.append(f"| **dec total** | {tot_d * 1e3 / iters:.1f} | | "
                     f"{pixels / (tot_d / iters) / 1e6:.1f} |")
    lines.append("")
    return "\n".join(lines)


def main():
    from go_jpeg2000_tpu.utils import device_info
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    dev = device_info.require_gpu()
    frames = [natural_image(args.size, args.size, seed=i)
              for i in range(args.frames)]
    acc_ht, px, it = profile_ht(frames, iters=args.iters)
    eb_frames = frames[:8]
    acc_eb, px_eb, _ = profile_ebcot(eb_frames, iters=args.iters)

    out = ["# Stage-time table", "",
           f"device: {dev['kind']} x{dev['count']} "
           f"({device_info.nvidia_smi()}); "
           f"config: {args.frames}x{args.size}x{args.size} gray, "
           f"5/3 lossless, {args.iters} iters", "",
           fmt_table(f"HTJ2K fused path ({args.frames} frames)", acc_ht, px, it),
           fmt_table("EBCOT device path (8 frames)", acc_eb, px_eb, it)]
    text = "\n".join(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
