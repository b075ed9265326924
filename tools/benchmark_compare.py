#!/usr/bin/env python
"""Benchmark comparison vs OpenJPEG (via Pillow/libopenjp2).

Parity with the reference's harness (/root/reference/benchmark_compare.go:
19-173) which compares its Go codec against opj_compress/opj_decompress:
encodes/decodes RGBA-like images at 64..512 px, reports wall-clock ratios.
Run: python tools/benchmark_compare.py
"""
from __future__ import annotations

import io
import time

import numpy as np


def natural(h, w, c, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, size=(h, w, c)).astype(np.float32)
    for ax in (0, 1):
        a = (a + np.roll(a, 1, axis=ax) + np.roll(a, -1, axis=ax)) / 3
    return a.astype(np.uint8)


def time_it(fn, iters):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def main():
    import go_jpeg2000_tpu as jp2k
    from go_jpeg2000_tpu.options import Format, Options
    from PIL import Image

    iters = 5
    print(f"{'size':>6} | {'ours enc':>9} {'opj enc':>9} {'ratio':>6} | "
          f"{'ours dec':>9} {'opj dec':>9} {'ratio':>6} | ht enc/dec")
    for size in (64, 128, 256, 512):
        img = natural(size, size, 3, seed=size)
        opts = Options(format=Format.J2K, lossless=True, num_resolutions=5)
        opts_ht = Options(format=Format.J2K, lossless=True,
                          num_resolutions=5, high_throughput=True)

        t_enc, data = time_it(lambda: jp2k.encode(img, opts), iters)
        t_dec, dec = time_it(lambda: jp2k.decode(data), iters)
        assert np.array_equal(dec, img)
        t_hte, data_ht = time_it(lambda: jp2k.encode(img, opts_ht), iters)
        t_htd, dec_ht = time_it(lambda: jp2k.decode(data_ht), iters)
        assert np.array_equal(dec_ht, img)

        def opj_enc():
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG2000",
                                      irreversible=False, num_resolutions=5)
            return buf.getvalue()

        t_oenc, opj_data = time_it(opj_enc, iters)

        def opj_dec():
            return np.asarray(Image.open(io.BytesIO(opj_data)))

        t_odec, opj_out = time_it(opj_dec, iters)
        assert np.array_equal(opj_out, img)

        print(f"{size:>6} | {t_enc*1e3:8.1f}m {t_oenc*1e3:8.1f}m "
              f"{t_enc/t_oenc:6.2f} | {t_dec*1e3:8.1f}m {t_odec*1e3:8.1f}m "
              f"{t_dec/t_odec:6.2f} | {t_hte*1e3:6.1f}m/{t_htd*1e3:6.1f}m")


if __name__ == "__main__":
    main()
