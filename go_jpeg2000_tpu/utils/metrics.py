"""In-pipeline observability counters (SURVEY §5.5).

The reference has zero observability (no log statements, no counters —
SURVEY §5: "errors are returned, not logged"); the blueprint requires
pipeline counters surfaced to callers.  A single process-wide registry
keeps the hot paths branch-light: `counters.add` is one dict update under
a lock only when contended (CPython dict ops are atomic enough for
monotonic counters; the lock guards snapshot/reset consistency).

Usage:
    from go_jpeg2000_tpu.utils.metrics import counters
    counters.add("dec.packets_parsed")
    counters.snapshot()  # {"dec.packets_parsed": 1, ...}

Counter namespace (maintained by encoder.py / decoder.py / rate.py):
    enc.pixels_in        pixels submitted to encode
    enc.bytes_out        codestream bytes produced
    enc.blocks_coded     code-blocks entropy-coded
    enc.passes_coded     coding passes emitted
    enc.truncation_points  pass boundaries available to PCRD
    enc.fused_ht_frames  frames coded by the fused device HT program
    enc.fused_cap_fallback  fused HT chunks whose stream pools overflowed
                         every cap retry (coded on the host instead)
    enc.ebcot_device_frames  frames coded by device EBCOT path A
    enc.ebcot_hybrid_frames  frames coded by device EBCOT path B
    enc.ebcot_cap_fallback  device EBCOT chunks that overflowed (host coded)
    enc.device_transform_frames  frames/tiles through the device forward
                         transform feeding host entropy coding
    enc.sharded_transform_tiles  tiles through the mesh forward transform
    enc.sharded_device_ht_tiles  tiles HT-coded on the mesh
    dec.bytes_in         codestream bytes consumed
    dec.pixels_out       pixels reconstructed
    dec.packets_parsed   packet headers parsed
    dec.packets_skipped  packets skipped whole via PLT seek (region decode)
    dec.packet_bytes_skipped  bytes skipped via PLT seek
    dec.blocks_decoded   code-blocks entropy-decoded
    dec.blocks_skipped   blocks outside the decode area (region decode)
    dec.tiles_decoded    tiles decoded
    dec.tiles_skipped    tiles outside the decode area
    dec.device_ht_chunks  decode_batch chunks with device MagSgn decode
    dec.device_transform_frames  frames/tiles through the device inverse
                         transform after host entropy decoding
    dec.sharded_transform_tiles  tiles through the mesh inverse transform
    dec.sharded_device_ht_tiles  tiles with device MagSgn decode on the mesh
"""
from __future__ import annotations

import threading
from typing import Dict


class Counters:
    def __init__(self) -> None:
        self._c: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def get(self, name: str) -> int:
        return self._c.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    def reset(self) -> None:
        with self._lock:
            self._c.clear()


counters = Counters()
