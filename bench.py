#!/usr/bin/env python
"""Benchmark: prints ONE JSON line {metric, value, unit, device, gpu}.

Headline metric: Mpixels/s, encode+decode, HTJ2K lossless 5/3 on 512x512
gray frames (BASELINE config 3).  Runs on a GPU only: with no GPU it exits
non-zero before timing anything.

Every secondary number goes to stderr, each labeled with what it measures:
  - ht53_512_device_mpix_s: device-compute throughput of the fused
    transform+HT-fields+compaction program (synced, no transfers).
  - ht53_{512,2048}*, ebcot53_512*: end-to-end encode/decode
    (h2d + compute + d2h + host serialize/T2).
  - lossy97_512_psnr_db / _opj_psnr_db: config-2 matched-rate (20:1)
    quality vs OpenJPEG on identical content (OpenJPEG through Pillow,
    when Pillow is installed).
  - sharded16_1024_{ht,ebcot}_mpix_s: config-4 (multi-tile 16-bit +
    MCT) through parallel.sharded.encode_sharded on a mesh of every
    visible device.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def natural_image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=(h, w)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def run_config(frames, opts, encode_batch, decode_batch, iters=3):
    """Best-of-N end-to-end wall times."""
    outs = encode_batch(frames, opts)           # warm-up (jit, native build)
    decs = decode_batch(outs)
    assert all(np.array_equal(d, f) for d, f in zip(decs, frames)), \
        "lossless round-trip must be bit-exact"
    t_enc = min(_timed(lambda: encode_batch(frames, opts))
                for _ in range(iters))
    t_dec = min(_timed(lambda: decode_batch(outs)) for _ in range(iters))
    decs = decode_batch(outs)
    assert all(np.array_equal(d, f) for d, f in zip(decs, frames))
    pixels = sum(f.size for f in frames)
    return pixels / t_enc / 1e6, pixels / t_dec / 1e6, \
        (2 * pixels) / (t_enc + t_dec) / 1e6


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def device_compute_ht(frames, iters=10):
    """Synced on-device throughput of the fused HT encode program (no
    transfers): upload once, run the jitted transform+fields+compaction,
    sync with a 1-element readback."""
    import jax
    from go_jpeg2000_tpu.models import fused_encode
    from go_jpeg2000_tpu.models.encoder import (build_header,
                                                _image_components)
    from go_jpeg2000_tpu.options import Format, Options
    from go_jpeg2000_tpu.tcd import geometry as geo

    opts = Options(format=Format.J2K, lossless=True, num_resolutions=6,
                   high_throughput=True)
    header = build_header(frames[0], opts)
    tile = geo.build_tile(header, 0)
    plan = fused_encode.plan_for(header, tile)
    if plan is None:
        return -1.0
    batch = np.stack([np.stack(_image_components(im)) for im in frames])
    n, c, h, w = batch.shape
    caps = fused_encode._caps_for(plan, n)
    fn = fused_encode._fused_fn(n, c, h, w, 5, False,
                                header.components[0].precision, False,
                                fused_encode._plan_key(plan), *caps)
    flat = jax.device_put(np.ascontiguousarray(batch).reshape(-1))
    out = fn(flat)
    np.asarray(out.reshape(-1)[:1])
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(flat)
    np.asarray(out.reshape(-1)[:1])
    dt = (time.perf_counter() - t0) / iters
    return n * h * w / dt / 1e6


def lossy_psnr(size=512, ratio=20.0, fmt=None, num_layers=3):
    """Config 2: 9/7 + ICT PCRD @ratio; PSNR vs the original, and
    OpenJPEG's PSNR at the same rate when PIL is present (mct=1 so both
    encoders run the ICT — PIL's default disables MCT)."""
    import go_jpeg2000_tpu as jp2k
    from go_jpeg2000_tpu.options import Format, Options

    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, size=(size, size, 3)).astype(np.float32)
    for ax in (0, 1):
        for _ in range(2):
            a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    img = a.astype(np.uint8)

    def psnr(x):
        mse = np.mean((x.astype(np.float64) - img.astype(np.float64)) ** 2)
        return 10 * np.log10(255.0 ** 2 / mse) if mse else float("inf")

    t0 = time.perf_counter()
    ours = jp2k.encode(img, Options(
        format=fmt if fmt is not None else Format.J2K, lossless=False,
        quality=98, num_resolutions=6,
        num_layers=num_layers, compression_ratio=ratio, backend="native"))
    t_enc = time.perf_counter() - t0
    p_ours = psnr(jp2k.decode(ours))
    p_opj = -1.0
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        import io
        b = io.BytesIO()
        Image.fromarray(img).save(b, format="JPEG2000", irreversible=True,
                                  quality_mode="rates",
                                  quality_layers=[ratio], num_resolutions=6,
                                  mct=1)
        p_opj = psnr(np.asarray(Image.open(b)))
    return round(p_ours, 2), round(p_opj, 2), \
        round(img.size / t_enc / 1e6, 2)


def sharded_config4(size=1024, tile=512):
    """Config 4 (scaled to bench time): multi-tile 16-bit RGB + MCT via
    the mesh-sharded pipeline on however many chips are present."""
    import jax
    from go_jpeg2000_tpu.models import decoder
    from go_jpeg2000_tpu.options import Format, Options
    from go_jpeg2000_tpu.parallel import mesh as pmesh
    from go_jpeg2000_tpu.parallel import sharded

    rng = np.random.RandomState(1)
    a = rng.randint(0, 1 << 16, size=(size, size, 3)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    img = a.astype(np.uint16)
    mesh = pmesh.make_mesh(len(jax.devices()))
    out = {}
    for label, ht in (("ht", True), ("ebcot", False)):
        opts = Options(format=Format.J2K, lossless=True, num_resolutions=5,
                       tile_size=(tile, tile), high_throughput=ht)
        data = sharded.encode_sharded(img, mesh, opts)    # warm-up
        t = min(_timed(lambda: sharded.encode_sharded(img, mesh, opts))
                for _ in range(2))
        dec = decoder.decode(data)
        assert np.array_equal(dec, img),             "config-4 round-trip must be bit-exact"
        out[label] = round(img.size / t / 1e6, 2)
        if ht:
            # mesh-sharded decode with device HT entropy (r5)
            dec2 = sharded.decode_sharded(data, mesh)     # warm-up
            assert np.array_equal(dec2, img)
            td = min(_timed(lambda: sharded.decode_sharded(data, mesh))
                     for _ in range(2))
            out["ht_dec"] = round(img.size / td / 1e6, 2)

    # lossy 9/7 through the sharded pipeline (r5 cont.): device ICT +
    # sharded 9/7 DWT + on-device deadzone quant + device HT entropy;
    # decode via the sharded device MagSgn + dequant + inverse 9/7
    img8 = (img >> 8).astype(np.uint8)
    opts = Options(format=Format.J2K, lossless=False, quality=85,
                   num_resolutions=5, tile_size=(tile, tile),
                   high_throughput=True)
    data = sharded.encode_sharded(img8, mesh, opts)       # warm-up
    t = min(_timed(lambda: sharded.encode_sharded(img8, mesh, opts))
            for _ in range(2))
    dec = sharded.decode_sharded(data, mesh)              # warm-up
    mse = float(np.mean((dec.astype(np.float64) - img8) ** 2))
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 25.0, \
        "sharded lossy quality collapsed"
    td = min(_timed(lambda: sharded.decode_sharded(data, mesh))
             for _ in range(2))
    out["htlossy"] = round(img8.size / t / 1e6, 2)
    out["htlossy_dec"] = round(img8.size / td / 1e6, 2)
    return out


def main():
    from go_jpeg2000_tpu.utils import device_info
    device = device_info.require_gpu()
    gpu = device_info.nvidia_smi()
    from go_jpeg2000_tpu.models.encoder import encode_batch
    from go_jpeg2000_tpu.models.decoder import decode_batch
    from go_jpeg2000_tpu.options import Format, Options

    details = {}

    # --- config 3: HTJ2K lossless (headline; production throughput path) ---
    def progress(k):
        print(f"[bench] {k} done", file=sys.stderr, flush=True)

    ht_frames = [natural_image(512, 512, seed=i) for i in range(32)]
    ht_opts = Options(format=Format.J2K, lossless=True, num_resolutions=6,
                      high_throughput=True, backend="auto")
    ht_enc, ht_dec, ht_encdec = run_config(
        ht_frames, ht_opts, encode_batch, decode_batch)
    details.update({
        "ht53_512_encdec_mpix_s": round(ht_encdec, 3),
        "ht53_512_encode_mpix_s": round(ht_enc, 3),
        "ht53_512_decode_mpix_s": round(ht_dec, 3),
    })
    progress("ht512")

    # device-compute capability (no transfers)
    details["ht53_512_device_mpix_s"] = round(
        device_compute_ht(ht_frames[:8]), 1)
    progress("device_compute")

    # --- config 3 at 2048^2 (amortizes per-dispatch overhead) ---
    big_frames = [natural_image(2048, 2048, seed=i) for i in range(2)]
    b_enc, b_dec, b_encdec = run_config(
        big_frames, ht_opts, encode_batch, decode_batch, iters=2)
    details.update({
        "ht53_2048_encdec_mpix_s": round(b_encdec, 3),
        "ht53_2048_encode_mpix_s": round(b_enc, 3),
        "ht53_2048_decode_mpix_s": round(b_dec, 3),
    })
    progress("ht2048")

    # --- config 1: standard EBCOT J2K lossless (the reference's coder) ---
    eb_frames = [natural_image(512, 512, seed=i) for i in range(8)]
    eb_opts = Options(format=Format.J2K, lossless=True, num_resolutions=6,
                      high_throughput=False, backend="auto")
    eb_enc, eb_dec, eb_encdec = run_config(
        eb_frames, eb_opts, encode_batch, decode_batch, iters=2)
    details.update({
        "ebcot53_512_encdec_mpix_s": round(eb_encdec, 3),
        "ebcot53_512_encode_mpix_s": round(eb_enc, 3),
        "ebcot53_512_decode_mpix_s": round(eb_dec, 3),
    })
    progress("ebcot512")

    # --- config 2: lossy 9/7 + ICT PCRD 20:1, PSNR vs OpenJPEG ---
    p_ours, p_opj, enc_rate = lossy_psnr()
    details.update({"lossy97_512_psnr_db": p_ours,
                    "lossy97_512_opj_psnr_db": p_opj,
                    "lossy97_512_encode_mpix_s": enc_rate})
    progress("lossy97")

    # --- config 2 at its SPECIFIED scale: 2048^2 sRGB, quality layers,
    # PCRD @20:1, JP2 container (BASELINE.md row 4) ---
    p_ours, p_opj, enc_rate = lossy_psnr(size=2048, fmt=Format.JP2)
    details.update({"lossy97_2048_psnr_db": p_ours,
                    "lossy97_2048_opj_psnr_db": p_opj,
                    "lossy97_2048_encode_mpix_s": enc_rate})
    progress("lossy97_2048")

    # --- config 3 lossy leg: HTJ2K 9/7 through the fused DEVICE paths
    # (on-device quant + HT fields; decode: device MagSgn + inverse) ---
    ht_lossy = Options(format=Format.J2K, lossless=False, quality=85,
                       num_resolutions=6, high_throughput=True,
                       backend="auto")
    frames = [natural_image(512, 512, seed=i) for i in range(16)]
    outs = encode_batch(frames, ht_lossy)
    decs = decode_batch(outs)
    mse = float(np.mean([np.mean((d.astype(np.float64) - f) ** 2)
                         for d, f in zip(decs, frames)]))
    t_enc = min(_timed(lambda: encode_batch(frames, ht_lossy))
                for _ in range(2))
    t_dec = min(_timed(lambda: decode_batch(outs)) for _ in range(2))
    px = sum(f.size for f in frames)
    details.update({
        "htlossy97_512_encode_mpix_s": round(px / t_enc / 1e6, 3),
        "htlossy97_512_decode_mpix_s": round(px / t_dec / 1e6, 3),
        "htlossy97_512_psnr_db": round(
            10 * np.log10(255.0 ** 2 / mse), 2) if mse else -1.0,
    })
    progress("htlossy97")

    # --- config 4: sharded multi-tile 16-bit + MCT (HT + EBCOT coders) ---
    c4 = sharded_config4()
    details["sharded16_1024_ht_mpix_s"] = c4["ht"]
    details["sharded16_1024_ebcot_mpix_s"] = c4["ebcot"]
    details["sharded16_1024_ht_dec_mpix_s"] = c4["ht_dec"]
    details["sharded8_1024_htlossy97_mpix_s"] = c4["htlossy"]
    details["sharded8_1024_htlossy97_dec_mpix_s"] = c4["htlossy_dec"]
    progress("sharded16")

    details["gpu"] = gpu
    print(json.dumps(details, indent=1), file=sys.stderr)
    print(json.dumps({
        "metric": "mpixels_per_s_encdec_ht53_512",
        "value": round(ht_encdec, 3),
        "unit": "Mpix/s",
        "device": device,
        "gpu": gpu,
    }))


if __name__ == "__main__":
    main()
