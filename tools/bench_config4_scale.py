"""Config-4 at its SPECIFIED scale (BASELINE.json row 4: 8192^2 multi-tile
12/16-bit + MCT, sharded).

bench.py runs sharded_config4 at 1024^2 (scaled to bench time).  This
tool measures the SAME sharded pipeline at 2048/4096/8192 so the
full-scale number can be recorded without burdening the bench.

Usage:
    python tools/bench_config4_scale.py [size ...]      # default 2048 4096

Each size uses tile = size // 4 (16 tiles, the config-4 shape) and prints
one row: encode / decode Mpix/s for the HT coder plus the lossy-9/7 leg.
"""
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [2048, 4096]
    print("| size | tiles | ht enc | ht dec | ebcot enc | lossy97 enc | lossy97 dec |")
    print("|---|---|---|---|---|---|---|")
    for size in sizes:
        tile = size // 4
        out = bench.sharded_config4(size=size, tile=tile)
        print("| %d^2 | %dx%d | %.2f | %.2f | %.2f | %.2f | %.2f |" % (
            size, size // tile, size // tile,
            out.get("ht", -1), out.get("ht_dec", -1), out.get("ebcot", -1),
            out.get("htlossy", -1), out.get("htlossy_dec", -1)),
            flush=True)


if __name__ == "__main__":
    main()
