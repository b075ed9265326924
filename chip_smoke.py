#!/usr/bin/env python
"""Proof that the codec's device path runs on a GPU.

Drives the main path through the entry points a user calls (`encode`,
`decode`, `encode_batch`, `decode_batch`, `encode_sharded`,
`decode_sharded`) at the real sizes of the repo's configurations, with
images generated from a fixed seed.  Each phase:

  - runs once to compile and once timed, and prints one JSON line with the
    compile seconds (JAX's trace + lower + backend-compile events), the
    timed run's seconds and Mpix/s, backend compiles inside the timed run,
    peak device memory, the card with its power limit, the JAX version and
    the compile-cache directory;
  - compares its output with the CPU backend in the same process
    (`jax.devices("cpu")` under `jax.default_device`) on 1-2 frames:
    lossless codestreams byte-identical and decodes bit-exact; lossy PSNR
    within 0.05 dB (the 9/7 lifting and ICT are float32 scalar multiplies
    and adds, which a GPU may contract into FMAs and sum in another order,
    so lossy bits may differ; there is no matrix product, so TF32 plays no
    part);
  - checks from `go_jpeg2000_tpu.counters` that its device path ran: a
    phase that fell back to the host fails.

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Any failure raises: the script then exits non-zero and prints no ok line,
as it does when JAX finds no GPU or the native library cannot be built.

Usage:
    python chip_smoke.py             # every phase, one GPU
    python chip_smoke.py --quick     # compile and compare each phase once,
                                     # print fused programs' memory_analysis()
    python chip_smoke.py --chips 4   # the sharded phase only, on a
                                     # (dp=2, sp=2) mesh of four GPUs
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax

import go_jpeg2000_tpu as jp2k
from go_jpeg2000_tpu.models import decoder, encoder
from go_jpeg2000_tpu.options import Config, Format, Options
from go_jpeg2000_tpu.parallel import mesh as pmesh
from go_jpeg2000_tpu.parallel import sharded

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
LOSSY_PSNR_TOL_DB = 0.05


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, and the number
    of backend compiles, from its monitoring events."""

    def __init__(self):
        self.secs = 0.0
        self.compiles = 0
        jax.monitoring.register_event_duration_secs_listener(self)

    def __call__(self, event, duration, **kwargs):
        if event in _COMPILE_EVENTS:
            self.secs += duration
        if event == _COMPILE_EVENTS[-1]:
            self.compiles += 1


_CLOCK = None


def _clock() -> CompileClock:
    global _CLOCK
    if _CLOCK is None:
        _CLOCK = CompileClock()
    return _CLOCK


def natural_image(h, w, seed=0, channels=0, bits=8):
    """Smoothed uniform noise (bench.py's content), gray or `channels`-
    component, 8- or 16-bit."""
    rng = np.random.RandomState(seed)
    shape = (h, w, channels) if channels else (h, w)
    a = rng.randint(0, 1 << bits, size=shape).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8 if bits == 8 else np.uint16)


def psnr(x, ref, bits=8):
    mse = np.mean((x.astype(np.float64) - ref.astype(np.float64)) ** 2)
    peak = float((1 << bits) - 1)
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def max_diff(a, b):
    return int(np.max(np.abs(a.astype(np.int64) - b.astype(np.int64))))


def counter_delta(before):
    now = jp2k.counters.snapshot()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def expect(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(fn, quick, max_warmups=3):
    """Warm-up calls until one compiles nothing (adaptive stream caps may
    grow and recompile once after the first call), then, unless quick, one
    timed call.  Returns (result, stats); stats["calls"] counts every
    call."""
    clock = _clock()
    c0, k0, t0 = clock.secs, clock.compiles, time.perf_counter()
    calls = 0
    while True:
        k = clock.compiles
        out = fn()
        calls += 1
        if quick or clock.compiles == k or calls == max_warmups:
            break
    stats = {"warmup_calls": calls, "warmup_s": time.perf_counter() - t0,
             "compile_s": clock.secs - c0, "compiles": clock.compiles - k0}
    if not quick:
        k1, t1 = clock.compiles, time.perf_counter()
        out = fn()
        stats["run_s"] = time.perf_counter() - t1
        stats["compiles_in_run"] = clock.compiles - k1
        calls += 1
    stats["calls"] = calls
    return out, stats


def rate(stats, pixels):
    s = stats.get("run_s")
    return pixels / s / 1e6 if s else None


class Smoke:
    """Runs phases on the default device and references on `ref`."""

    def __init__(self, ref, quick=False):
        self.ref = ref
        self.quick = quick
        self.records = []

    def on_ref(self, fn):
        with jax.default_device(self.ref):
            expect(jax.numpy.zeros(()).devices() == {self.ref},
                   "reference computation is not on the CPU backend")
            return fn()

    def record(self, phase, pixels, enc=None, dec=None, **extra):
        rec = {"phase": phase, "mpix": pixels / 1e6}
        for name, st in (("enc", enc), ("dec", dec)):
            if st is None:
                continue
            for k, v in st.items():
                rec[f"{name}_{k}"] = v
            rec[f"{name}_mpix_s"] = rate(st, pixels)
        stats = jax.devices()[0].memory_stats() or {}
        rec["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        rec.update(extra)
        self.records.append(rec)
        return rec

    # ---- config 3: HT via encode_batch / decode_batch -------------------
    def ht_batch(self, phase, size, n, n_ref, lossless=True, quality=85):
        frames = [natural_image(size, size, seed=i) for i in range(n)]
        opts = Options(format=Format.J2K, lossless=lossless, quality=quality,
                       num_resolutions=6, high_throughput=True)
        before = jp2k.counters.snapshot()
        streams, enc = timed(lambda: encoder.encode_batch(frames, opts),
                             self.quick)
        decs, dec = timed(lambda: decoder.decode_batch(streams), self.quick)
        delta = counter_delta(before)
        expect(delta.get("enc.fused_ht_frames", 0) == n * enc["calls"],
               f"{phase}: fused HT encode did not run on every frame "
               f"({delta})")
        expect(delta.get("dec.device_ht_chunks", 0) >= dec["calls"],
               f"{phase}: device HT decode did not run ({delta})")
        expect("enc.fused_cap_fallback" not in delta,
               f"{phase}: fused pools overflowed to the host path")
        ref_streams = self.on_ref(
            lambda: encoder.encode_batch(frames[:n_ref], opts))
        ref_decs = self.on_ref(lambda: decoder.decode_batch(ref_streams))
        extra = {}
        if lossless:
            expect(streams[:n_ref] == ref_streams,
                   f"{phase}: codestream differs from the CPU backend's")
            for d, f in zip(decs, frames):
                expect(np.array_equal(d, f), f"{phase}: decode not exact")
            for d, f in zip(ref_decs, frames):
                expect(np.array_equal(d, f),
                       f"{phase}: CPU decode not exact")
        else:
            p_dev = [psnr(d, f) for d, f in zip(decs[:n_ref], frames)]
            p_ref = [psnr(d, f) for d, f in zip(ref_decs, frames)]
            extra = {"psnr_gpu_db": p_dev, "psnr_cpu_db": p_ref,
                     "max_diff_vs_cpu": max(max_diff(a, b) for a, b in
                                            zip(decs, ref_decs)),
                     "bytes_equal_cpu": streams[:n_ref] == ref_streams}
            for a, b in zip(p_dev, p_ref):
                expect(abs(a - b) <= LOSSY_PSNR_TOL_DB,
                       f"{phase}: PSNR {a:.3f} dB vs CPU {b:.3f} dB")
        if self.quick:
            extra["memory_analysis"] = _fused_memory(frames, opts)
        return self.record(phase, n * size * size, enc, dec,
                           counters=delta, **extra)

    # ---- config 2: lossy 9/7 + ICT, 3 layers, PCRD 20:1, JP2 -----------
    def lossy_jp2(self, phase, size):
        img = natural_image(size, size, seed=0, channels=3)
        opts = Options(format=Format.JP2, lossless=False, quality=98,
                       num_resolutions=6, num_layers=3,
                       compression_ratio=20.0)
        before = jp2k.counters.snapshot()
        data, enc = timed(lambda: jp2k.encode(img, opts), self.quick)
        out, dec = timed(lambda: jp2k.decode(data), self.quick)
        delta = counter_delta(before)
        expect(delta.get("enc.device_transform_frames", 0) >= 1,
               f"{phase}: device forward transform did not run ({delta})")
        expect(delta.get("dec.device_transform_frames", 0) >= 1,
               f"{phase}: device inverse transform did not run ({delta})")
        ref_data = self.on_ref(lambda: jp2k.encode(img, opts))
        ref_out = self.on_ref(lambda: jp2k.decode(ref_data))
        p_dev, p_ref = psnr(out, img), psnr(ref_out, img)
        expect(data[:4] == b"\x00\x00\x00\x0c", f"{phase}: not a JP2 file")
        expect(abs(p_dev - p_ref) <= LOSSY_PSNR_TOL_DB,
               f"{phase}: PSNR {p_dev:.3f} dB vs CPU {p_ref:.3f} dB")
        return self.record(phase, img.shape[0] * img.shape[1], enc, dec,
                           counters=delta, psnr_gpu_db=p_dev,
                           psnr_cpu_db=p_ref,
                           max_diff_vs_cpu=max_diff(out, ref_out),
                           ratio=img.nbytes / len(data))

    # ---- config 1: EBCOT lossless, every user-selectable backend -------
    def ebcot(self, phase, size, n, n_ref):
        frames = [natural_image(size, size, seed=i) for i in range(n)]

        def opts(backend):
            return Options(format=Format.J2K, lossless=True,
                           num_resolutions=6, high_throughput=False,
                           backend=backend)

        ref = self.on_ref(lambda: encoder.encode_batch(frames[:n_ref],
                                                       opts("native")))
        path_counter = {"device": "enc.ebcot_device_frames",
                        "hybrid": "enc.ebcot_hybrid_frames",
                        "host": "enc.device_transform_frames"}
        recs = []
        for backend in ("auto", "native", "hybrid", "device"):
            path = {"auto": encoder.AUTO_EBCOT_PATH,
                    "native": "host"}.get(backend, backend)
            before = jp2k.counters.snapshot()
            streams, enc = timed(
                lambda: encoder.encode_batch(frames, opts(backend)),
                self.quick)
            delta = counter_delta(before)
            expect(delta.get(path_counter[path], 0) == n * enc["calls"],
                   f"{phase}/{backend}: path {path} did not run ({delta})")
            expect(all(delta.get(c, 0) == 0 for p, c in path_counter.items()
                       if p != path),
                   f"{phase}/{backend}: another EBCOT path ran ({delta})")
            expect(streams[:n_ref] == ref,
                   f"{phase}/{backend}: codestream differs from the CPU "
                   f"backend's")
            dec = None
            if backend == "auto":
                before = jp2k.counters.snapshot()
                decs, dec = timed(lambda: decoder.decode_batch(streams),
                                  self.quick)
                ddelta = counter_delta(before)
                expect(ddelta.get("dec.device_transform_frames", 0)
                       == n * dec["calls"],
                       f"{phase}: device inverse did not run ({ddelta})")
                for d, f in zip(decs, frames):
                    expect(np.array_equal(d, f), f"{phase}: decode not exact")
                delta.update(ddelta)
            recs.append(self.record(f"{phase}_{backend}", n * size * size,
                                    enc, dec, path=path, counters=delta))
        return recs

    # ---- config 4: sharded multi-tile 16-bit RGB ----------------------
    def sharded16(self, phase, size, tile, mesh):
        img = natural_image(size, size, seed=1, channels=3, bits=16)
        legs = {
            "ht": Options(format=Format.J2K, lossless=True,
                          num_resolutions=5, tile_size=(tile, tile),
                          high_throughput=True),
            "ebcot": Options(format=Format.J2K, lossless=True,
                             num_resolutions=5, tile_size=(tile, tile)),
            "budget": Options(format=Format.J2K, lossless=True,
                              num_resolutions=5, tile_size=(tile, tile),
                              num_layers=2, compression_ratio=6.0),
            "htlossy": Options(format=Format.J2K, lossless=False, quality=85,
                               num_resolutions=5, tile_size=(tile, tile),
                               high_throughput=True),
        }
        n_tiles = (size // tile) ** 2
        recs = []
        for leg, opts in legs.items():
            device_ht = leg in ("ht", "htlossy")
            before = jp2k.counters.snapshot()
            data, enc = timed(lambda: sharded.encode_sharded(img, mesh, opts),
                              self.quick)
            out, dec = timed(lambda: sharded.decode_sharded(data, mesh),
                             self.quick)
            delta = counter_delta(before)
            enc_c = ("enc.sharded_device_ht_tiles" if device_ht
                     else "enc.sharded_transform_tiles")
            expect(delta.get(enc_c, 0) == n_tiles * enc["calls"],
                   f"{phase}_{leg}: {enc_c} ({delta})")
            expect(delta.get("dec.sharded_transform_tiles", 0)
                   == n_tiles * dec["calls"],
                   f"{phase}_{leg}: mesh inverse ({delta})")
            if device_ht:
                expect(delta.get("dec.sharded_device_ht_tiles", 0)
                       == n_tiles * dec["calls"],
                       f"{phase}_{leg}: device HT decode ({delta})")
            single = self.on_ref(lambda: encoder.encode(img, opts))
            ref_out = self.on_ref(lambda: decoder.decode(data))
            extra = {}
            if leg == "htlossy":
                expect(max_diff(out, ref_out) <= 1,
                       f"{phase}_{leg}: decode_sharded differs from decode "
                       f"by more than 1")
                single_out = self.on_ref(lambda: decoder.decode(single))
                mse = np.mean((ref_out.astype(np.float64) - img) ** 2)
                mse1 = np.mean((single_out.astype(np.float64) - img) ** 2)
                expect(mse <= mse1 * 1.02 + 1e-9,
                       f"{phase}_{leg}: MSE {mse} vs single-device {mse1}")
                extra = {"psnr_db": psnr(out, img, 16),
                         "psnr_single_cpu_db": psnr(single_out, img, 16),
                         "max_diff_vs_decode": max_diff(out, ref_out)}
            else:
                expect(data == single, f"{phase}_{leg}: codestream differs "
                       f"from the single-device encoder's")
                expect(np.array_equal(out, ref_out),
                       f"{phase}_{leg}: decode_sharded differs from decode")
                if leg != "budget":
                    expect(np.array_equal(out, img),
                           f"{phase}_{leg}: decode not exact")
            if leg == "ht":
                extra["placement"] = placement(img, opts, mesh, data)
            recs.append(self.record(f"{phase}_{leg}", size * size, enc, dec,
                                    counters=delta, **extra))
        return recs


def placement(img, opts, mesh, data):
    """Device of each shard: the mesh transform's pyramid leaves (as
    encode_sharded builds them) and the leaves decode_sharded's device HT
    entropy produces."""
    from go_jpeg2000_tpu.codestream.parser import Parser
    th, tw = opts.tile_size[1], opts.tile_size[0]
    tiles = [np.moveaxis(img[y:y + th, x:x + tw], -1, 0)
             for y in range(0, img.shape[0], th)
             for x in range(0, img.shape[1], tw)]
    step = sharded.make_tile_transform_step(
        mesh, opts.num_resolutions - 1, True, 16, False)
    pyr, _ = step(np.stack(tiles))
    enc = sorted((str(s.device), str(s.index))
                 for s in pyr[0]["HL"].addressable_shards)
    _fmt, cs, _jp2 = decoder.sniff_format(data)
    parser = Parser(cs)
    header = parser.read_header()
    parts = {}
    for tp in parser.read_all_tile_parts(header):
        parts.setdefault(tp.tile_index, []).append(tp)
    leaves = sharded._device_ht_decode(header, parts, cs, header.num_tiles,
                                       Config())
    dec = sorted(str(d) for d in leaves[0]["HL"].devices())
    return {"encode_transform_shards": enc,
            "decode_ht_entropy_devices": dec}


def _fused_memory(frames, opts):
    """memory_analysis() of the fused HT encode program encode_batch
    compiled for these frames."""
    from go_jpeg2000_tpu.models import fused_encode
    from go_jpeg2000_tpu.ops import dwt
    from go_jpeg2000_tpu.tcd import geometry as geo
    h, w = frames[0].shape
    header = encoder.build_header(frames[0], opts)
    prec = header.components[0].precision
    encoder._apply_comp_quants(header, opts, 1, prec)
    tile = geo.build_tile(header, 0)
    plan = fused_encode.plan_for(header, tile, lossy=not opts.lossless)
    n = encoder._chunk_frames(len(frames), h * w)
    fn = fused_encode._fused_fn(
        n, 1, h, w, opts.num_resolutions - 1, False, prec, False,
        fused_encode._plan_key(plan), *fused_encode._caps_for(plan, n),
        kind=dwt.REV53 if opts.lossless else dwt.IRR97)
    arg = jax.ShapeDtypeStruct((n * h * w,), np.uint8)
    m = fn.lower(arg).compile().memory_analysis()
    return {k: getattr(m, k) for k in dir(m)
            if k.endswith("_in_bytes") and not k.startswith("_")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--quick", action="store_true",
                    help="compile and compare each phase once, print "
                         "memory_analysis(), no timed runs")
    args = ap.parse_args(argv)

    from go_jpeg2000_tpu.native import loader
    from go_jpeg2000_tpu.utils import device_info
    device = device_info.require_gpu()
    if device["count"] < args.chips:
        raise SystemExit(f"--chips {args.chips}: JAX sees {device['count']}")
    gpu = device_info.nvidia_smi()
    loader.require()
    env = {"gpu": gpu, "jax": jax.__version__,
           "cache_dir": jax.config.jax_compilation_cache_dir}
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps(env), flush=True)

    smoke = Smoke(jax.devices("cpu")[0], quick=args.quick)
    n_before = 0

    def flush():
        nonlocal n_before
        for rec in smoke.records[n_before:]:
            print(json.dumps(dict(rec, **env), default=str), flush=True)
        n_before = len(smoke.records)

    if args.chips == 4:
        smoke.sharded16("sharded16_4gpu", 2048, 512, pmesh.make_mesh(4))
        flush()
    else:
        smoke.ht_batch("ht_lossless_512", 512, 32, 2)
        flush()
        smoke.ht_batch("ht_lossless_2048", 2048, 2, 1)
        flush()
        smoke.ht_batch("htlossy97_512", 512, 16, 2, lossless=False)
        flush()
        smoke.lossy_jp2("lossy97_2048_jp2", 2048)
        flush()
        smoke.ebcot("ebcot53_512", 512, 8, 2)
        flush()
        smoke.sharded16("sharded16", 2048, 512, pmesh.make_mesh(1))
        flush()
    print(json.dumps({"ok": True, "device": device_info.jax_device()}))


if __name__ == "__main__":
    main()
