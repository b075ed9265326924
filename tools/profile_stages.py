#!/usr/bin/env python
"""Per-stage profiling of the encode/decode pipeline (VERDICT r1 item 2).

Times: transform dispatch+fetch, entropy, T2 assembly, decode parse,
block decode, inverse transform.
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


class T:
    def __init__(self):
        self.acc = {}

    def __call__(self, name):
        return _Span(self, name)


class _Span:
    def __init__(self, t, name):
        self.t, self.name = t, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *a):
        self.t.acc[self.name] = self.t.acc.get(self.name, 0.0) + (
            time.perf_counter() - self.t0)


def main():
    from go_jpeg2000_tpu.models import transforms, encoder, decoder
    from go_jpeg2000_tpu.models.entropy_backend import encode_blocks_batch
    from go_jpeg2000_tpu.options import Format, Options
    from go_jpeg2000_tpu.models.encoder import encode_batch
    from go_jpeg2000_tpu.models.decoder import decode_batch

    frames = [natural_image(512, 512, seed=i) for i in range(8)]
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=6,
                   high_throughput=True, backend="auto")

    # warm-up
    outs = encode_batch(frames, opts)
    decs = decode_batch(outs)
    assert np.array_equal(decs[0], frames[0])

    # ---- instrumented encode ----
    import go_jpeg2000_tpu.models.encoder as enc_mod
    import go_jpeg2000_tpu.models.decoder as dec_mod
    import go_jpeg2000_tpu.models.entropy_backend as eb

    t = T()

    orig_run_fb = transforms.run_forward_batch
    orig_encode_blocks = eb.encode_blocks_batch
    orig_build_tile = enc_mod.geo.build_tile

    def timed_run_fb(*a, **k):
        with t("enc.transform"):
            return orig_run_fb(*a, **k)

    def timed_encode_blocks(*a, **k):
        with t("enc.entropy"):
            return orig_encode_blocks(*a, **k)

    transforms.run_forward_batch = timed_run_fb
    enc_mod.transforms = transforms
    eb_orig = enc_mod.encode_blocks_batch
    enc_mod.encode_blocks_batch = timed_encode_blocks

    iters = 3
    with t("enc.total"):
        for _ in range(iters):
            outs = encode_batch(frames, opts)
    enc_mod.encode_blocks_batch = eb_orig
    transforms.run_forward_batch = orig_run_fb

    # ---- instrumented decode ----
    orig_dec_blocks = eb.decode_blocks_batch
    saved = dec_mod.decode_blocks_batch

    def timed_dec_blocks(*a, **k):
        with t("dec.entropy"):
            return orig_dec_blocks(*a, **k)

    dec_mod.decode_blocks_batch = timed_dec_blocks
    orig_run_inv = transforms.run_inverse_batch

    def timed_run_inv(*a, **k):
        with t("dec.inverse"):
            return orig_run_inv(*a, **k)

    transforms.run_inverse_batch = timed_run_inv

    with t("dec.total"):
        for _ in range(iters):
            decs = decode_batch(outs)
    dec_mod.decode_blocks_batch = saved
    transforms.run_inverse_batch = orig_run_inv

    pixels = sum(f.size for f in frames) * iters
    print(f"pixels/iter: {pixels//iters/1e6:.2f} Mpix, iters={iters}")
    for k in sorted(t.acc):
        v = t.acc[k]
        print(f"{k:24s} {v*1000/iters:9.1f} ms/iter  "
              f"{pixels/v/1e6:9.1f} Mpix/s")
    other_enc = t.acc["enc.total"] - t.acc.get("enc.transform", 0) - t.acc.get("enc.entropy", 0)
    other_dec = t.acc["dec.total"] - t.acc.get("dec.entropy", 0) - t.acc.get("dec.inverse", 0)
    print(f"{'enc.other(T2+host)':24s} {other_enc*1000/iters:9.1f} ms/iter")
    print(f"{'dec.other(parse+host)':24s} {other_dec*1000/iters:9.1f} ms/iter")


if __name__ == "__main__":
    main()
