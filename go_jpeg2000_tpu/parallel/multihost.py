"""Multi-host decomposition of the encode pipeline (BASELINE config 5).

A multi-host deployment runs one process per host, each owning its
devices; cross-host traffic is (a) the PCRD rate-allocation allreduce and
(b) one codestream gather at the end.  This module implements exactly
that process structure on a single machine — each "host" is a separate OS
process that sees ONLY its own tiles (produced, entropy-coded, PCRD'd and
assembled shard-locally), with a pipe-based reduction server standing in
for the inter-host network:

    host h:  tiles {t : t % n_hosts == h}
             transform + entropy  (shard-local)
             PCRD hulls           (shard-local)
             allreduce(sum/max/min) x O(log) rounds   <-- the only
             assemble tile-parts  (shard-local)            cross-host talk
    gather:  host 0 concatenates tile-parts by tile index + main header

The result is byte-identical to the single-process encoder: every PCRD
decision depends only on globally-reduced scalars, so all hosts derive the
same thresholds (models/rate.assign_layers_sharded), and the budget-fit
loop reduces the ACTUAL assembled sizes the same way
(models/encoder._assemble_with_budget with size_reduce).

On a real cluster the per-host compute half is
parallel.sharded.encode_sharded over that host's mesh and the reducer is
jax.distributed / psum across hosts;
the decomposition and message pattern are identical.  The reference has no
analog — nothing in it crosses a process boundary (SURVEY.md §5.8).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np


class PipeComm:
    """allreduce(vec, op) for one host: ships the host-local scalar to the
    reduction server over a Pipe and blocks for the global result.  The
    inter-host stand-in: every call is one round-trip, exactly the traffic a
    real multi-host PCRD pays per bisection probe."""

    def __init__(self, conn):
        self.conn = conn
        self.rounds = 0

    def __call__(self, vec, op: str):
        import math
        v = np.asarray(vec, np.float64)
        if op == "sum":
            local = float(v.sum())
        elif op == "max":
            local = float(v.max()) if v.size else -math.inf
        else:
            local = float(v.min()) if v.size else math.inf
        self.conn.send(("reduce", op, local))
        self.rounds += 1
        return self.conn.recv()


def _host_gate(opts) -> None:
    if opts.enable_ppm or opts.enable_tlm:
        raise ValueError("encode_multihost: PPM/TLM need a header-side "
                         "gather; disable them for multi-host encodes")


def host_encode_local(image: np.ndarray, opts, host_id: int, n_hosts: int,
                      comm) -> List[Tuple[int, bytes]]:
    """One host's half of the encode: transform + entropy + distributed
    PCRD + Tier-2 for the tiles this host OWNS (t % n_hosts == host_id).
    `comm(vec, op)` is the cross-host scalar allreduce.  Returns
    [(tile_index, tile_part_bytes)]."""
    from ..models import encoder as enc
    from ..models import rate as rate_mod
    from ..options import default_options

    opts = opts or default_options()
    _host_gate(opts)
    image = np.asarray(image)
    comps = enc._image_components(image)
    header = enc.build_header(image, opts)
    precision = header.components[0].precision
    signed = header.components[0].signed
    enc._apply_comp_quants(header, opts, len(comps), precision)
    main = enc._write_main_header(header, opts, len(comps))
    num_layers = header.coding_style.num_layers
    rate_budget = rate_mod.byte_budget(image, opts)

    my_tiles = [t for t in range(header.num_tiles)
                if t % n_hosts == host_id]
    states = []
    blocks = []
    weights: List[float] = []
    cw_mct = enc.mct_comp_weights(header, opts.lossless, len(comps))
    for t_idx in my_tiles:
        tile, enc_state, job_slots, results = enc._tile_entropy(
            header, comps, t_idx, opts, precision, signed, num_layers,
            rate_budget)
        b, w = enc._build_blocks(job_slots, results, num_layers,
                                 opts.lossless, cw_mct)
        blocks += b
        weights += w
        states.append((tile, enc_state))

    assign_fn = lambda target: rate_mod.assign_layers_sharded(
        [blocks], [weights], num_layers, target, allreduce=comm)
    size_reduce = lambda local: comm(np.asarray([float(local)]), "sum")
    tile_parts, _ppm = enc._assemble_with_budget(
        header, opts, states, blocks, num_layers, rate_budget, main,
        assign_fn, size_reduce=size_reduce, tile_ids=my_tiles)
    return list(zip(my_tiles, tile_parts))


def host_decode_local(data: bytes, config, host_id: int, n_hosts: int
                      ) -> List[Tuple[int, np.ndarray]]:
    """One host's half of the decode: full per-tile chain (T2 -> T1 ->
    inverse transform) for the tiles this host OWNS.  Decode needs no
    cross-host reductions at all — tiles are independent — so the only
    inter-host traffic is the final pixel gather.  Returns
    [(tile_index, samples int32 [C, th, tw])]."""
    from ..codestream.parser import Parser
    from ..models import decoder as dec
    from ..options import Config
    from ..tcd import geometry as geo

    config = config or Config()
    fmt, codestream, jp2 = dec.sniff_format(data)
    if jp2 is not None:
        raise ValueError("decode_multihost: raw J2K codestreams only "
                         "(colorspace conversion is a whole-image stage)")
    parser = Parser(codestream)
    header = parser.read_header()
    tile_parts = parser.read_all_tile_parts(header)
    parts_by_tile: Dict[int, list] = {}
    for tp in tile_parts:
        parts_by_tile.setdefault(tp.tile_index, []).append(tp)
    out = []
    for t in sorted(parts_by_tile):
        if t % n_hosts != host_id:
            continue
        tile = geo.build_tile(header, t,
                              parts_by_tile[t][0]
                              if parts_by_tile[t][0].coding_style else None)
        comps = dec._decode_tile(header, tile, parts_by_tile[t],
                                 codestream, config)
        out.append((t, np.stack([np.asarray(c, np.int32) for c in comps])))
    return out


def _child_main(conn) -> None:
    try:
        payload = pickle.loads(conn.recv_bytes())
        op = payload[0]
        # start barrier: scaling measurements must exclude interpreter /
        # JAX import time (on a real pod the processes are long-lived);
        # warm-up rounds additionally exclude first-call jit compiles
        conn.send(("ready",))
        assert conn.recv() == "go"
        if op == "encode":
            (_, image, opts, host_id, n_hosts, warmups) = payload
            comm = PipeComm(conn)
            for _ in range(warmups):
                host_encode_local(image, opts, host_id, n_hosts, comm)
                conn.send(("warm",))
                assert conn.recv() == "go"
            parts = host_encode_local(image, opts, host_id, n_hosts, comm)
            conn.send(("parts", parts, comm.rounds))
        else:
            (_, data, config, host_id, n_hosts, warmups) = payload
            for _ in range(warmups):
                host_decode_local(data, config, host_id, n_hosts)
                conn.send(("warm",))
                assert conn.recv() == "go"
            parts = host_decode_local(data, config, host_id, n_hosts)
            conn.send(("parts", parts, 0))
    except Exception as e:  # surface the traceback to the parent
        import traceback
        conn.send(("error", f"{e!r}\n{traceback.format_exc()}"))
    finally:
        conn.close()


def encode_multihost(image: np.ndarray, opts=None, n_hosts: int = 2,
                     _stats: Optional[dict] = None,
                     warmups: int = 0) -> bytes:
    """Encode with `n_hosts` separate OS processes, each owning its tile
    subset end-to-end, reduction-server pipes standing in for the network.
    Output is byte-identical to models.encoder.encode
    (tests/test_multihost.py).
    warmups > 0 runs that many throwaway encodes in the children first so
    _stats['compute_wall_s'] measures the steady state (no jit compiles)."""
    from ..models import encoder as enc
    from ..models import rate as rate_mod
    from ..options import default_options

    opts = opts or default_options()
    _host_gate(opts)
    image = np.asarray(image)

    if n_hosts <= 1:
        # degenerate case: run the host half inline (no processes)
        import time
        for _ in range(warmups):
            host_encode_local(image, opts, 0, 1, rate_mod._np_allreduce)
        t0 = time.perf_counter()
        parts = host_encode_local(image, opts, 0, 1, rate_mod._np_allreduce)
        if _stats is not None:
            _stats["compute_wall_s"] = time.perf_counter() - t0
        return _finalize(image, opts, parts, _stats)

    parts = _run_hosts(
        lambda h: ("encode", image, opts, h, n_hosts, warmups),
        n_hosts, warmups, _stats)
    return _finalize(image, opts, parts, _stats)


def _run_hosts(payload_for, n_hosts: int, warmups: int,
               _stats: Optional[dict]):
    """Spawn n_hosts worker processes, serve their reductions, gather their
    per-tile results (sorted by host, then tile order within host)."""
    ctx = mp.get_context("spawn")
    conns = []
    procs = []
    # children must never open the accelerator (one process per card: a
    # JAX process reserves most of the card's memory): pin them to CPU via
    # the inherited environment, restored after spawn
    saved = {"JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS")}
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        for h in range(n_hosts):
            parent_conn, child_conn = ctx.Pipe()
            p = ctx.Process(target=_child_main, args=(child_conn,),
                            daemon=True)
            p.start()
            child_conn.close()
            parent_conn.send_bytes(pickle.dumps(payload_for(h)))
            conns.append(parent_conn)
            procs.append(p)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    import time
    results: Dict[int, list] = {}
    rounds = 0

    def fail(err):
        for p in procs:
            p.terminate()
        raise RuntimeError(f"multihost child failed: {err}")

    def serve_until(tag: str) -> None:
        """Reduction server: every host sends one (op, local) per round in
        lockstep (each runs the identical, globally-driven control flow);
        runs until every host has sent `tag`."""
        nonlocal rounds
        active = set(range(n_hosts))
        pend: List[Tuple[int, str, float]] = []
        while active:
            pend.clear()
            for h in sorted(active):
                msg = conns[h].recv()
                if msg[0] == tag:
                    if tag == "parts":
                        results[h] = msg[1]
                    active.discard(h)
                elif msg[0] == "error":
                    fail(msg[1])
                else:
                    pend.append((h, msg[1], msg[2]))
            if pend:
                op = pend[0][1]
                assert all(o == op for _, o, _ in pend), "reduce op skew"
                vals = [v for _, _, v in pend]
                if op == "sum":
                    # integer-exact ordering-free sum (PCRD byte totals)
                    g = float(sum(int(round(v)) for v in vals)) \
                        if all(float(v).is_integer() for v in vals) \
                        else float(sum(vals))
                elif op == "max":
                    g = max(vals)
                else:
                    g = min(vals)
                for h, _, _ in pend:
                    conns[h].send(g)
                rounds += 1

    # start barrier (see _child_main)
    for h in range(n_hosts):
        msg = conns[h].recv()
        if msg[0] == "error":
            fail(msg[1])
        assert msg[0] == "ready"
    for h in range(n_hosts):
        conns[h].send("go")
    for _ in range(warmups):
        serve_until("warm")
        for h in range(n_hosts):
            conns[h].send("go")
    t0 = time.perf_counter()
    serve_until("parts")
    compute_wall = time.perf_counter() - t0
    for p in procs:
        p.join(timeout=30)

    if _stats is not None:
        _stats["reduce_rounds"] = rounds
        _stats["compute_wall_s"] = compute_wall
    return [pt for h in sorted(results) for pt in results[h]]


def decode_multihost(data: bytes, config=None, n_hosts: int = 2,
                     _stats: Optional[dict] = None,
                     warmups: int = 0) -> np.ndarray:
    """Decode with `n_hosts` separate OS processes, each running the full
    per-tile chain for its tile subset.  Decode needs NO cross-host
    reductions (tiles are independent); the only gather is the final pixel
    assembly — exactly the config-5 decode structure.  Pixel-identical to
    models.decoder.decode (tests/test_multihost.py)."""
    from ..codestream.parser import Parser
    from ..models import decoder as dec
    from ..options import Config

    config = config or Config()
    if config.decode_area is not None or config.reduce_resolution:
        raise ValueError("decode_multihost: full-frame decodes only")
    if n_hosts <= 1:
        parts = host_decode_local(data, config, 0, 1)
    else:
        parts = _run_hosts(
            lambda h: ("decode", data, config, h, n_hosts, warmups),
            n_hosts, warmups, _stats)

    fmt, codestream, _jp2 = dec.sniff_format(data)
    header = Parser(codestream).read_header()
    n_comps = header.num_components
    precision = header.components[0].precision
    signed = header.components[0].signed
    out_h = header.height - header.y_offset
    out_w = header.width - header.x_offset
    planes = np.zeros((n_comps, out_h, out_w), np.int32)
    for t, samples in parts:
        tx0, ty0, tx1, ty1 = header.tile_bounds(t)
        planes[:, ty0 - header.y_offset:ty1 - header.y_offset,
               tx0 - header.x_offset:tx1 - header.x_offset] = samples
    if precision <= 8:
        dt = np.int8 if signed else np.uint8
    elif precision <= 16:
        dt = np.int16 if signed else np.uint16
    else:
        dt = np.int32
    img = planes[0] if n_comps == 1 else np.moveaxis(planes, 0, -1)
    return img.astype(dt)


def _finalize(image, opts, parts: List[Tuple[int, bytes]],
              _stats: Optional[dict]) -> bytes:
    """The codestream gather: order tile-parts by tile index, prepend the
    main header, append EOC (host-0's job on a real pod)."""
    from ..models import encoder as enc
    image = np.asarray(image)
    comps = enc._image_components(image)
    header = enc.build_header(image, opts)
    enc._apply_comp_quants(header, opts, len(comps),
                           header.components[0].precision)
    main = enc._write_main_header(header, opts, len(comps))
    ordered = [b for _t, b in sorted(parts)]
    if _stats is not None:
        _stats["gathered_bytes"] = sum(len(b) for b in ordered)
    return enc._finalize_codestream(header, opts, main, ordered, [],
                                    int(image.size))
