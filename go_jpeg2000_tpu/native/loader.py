"""Native (C++) entropy backend: builds and binds j2k_native.so via ctypes.

The native library parallelizes T1/MQ block coding across code-blocks with a
thread pool — the analog of the reference's goroutine pool
(/root/reference/encoder.go:690-742) and assembly kernels (dwt_amd64.s,
t1_amd64.s).  Bit-identical to the Python oracle in ops/t1.py and
differentially tested against it (tests/test_native.py).

The library is built from the tracked sources into `_build/`, under a name
keyed by the sources' content hash, the compiler and the host CPU (the build
uses -march=native).  A library built on another machine, or from other
sources, therefore never matches and is never loaded: the first process on a
new host compiles its own.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops import t1 as t1_py

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "j2k_native.cpp")
_SOURCES = (_SRC, os.path.join(_HERE, "ht_tables.inc"))
_BUILD_DIR = os.path.join(_HERE, "_build")
_CXX = "g++"
_BASE_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
# -march=native is worth ~20% on the block coders; the portable flags are
# the fallback when the toolchain rejects it
_FLAG_SETS = (["-march=native", "-funroll-loops"], [])

MAX_PASSES = 160
MAX_SEGS = 160
# internal style bit (j2k_native.cpp STY_FAST_RATES): skip exact D.4.1
# pass truncation lengths, record monotone upper bounds instead
STY_FAST_RATES = 0x100

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

BAND_CLASS = {"LL": 0, "LH": 0, "HL": 1, "HH": 2}


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def _host_id() -> str:
    """What a -march=native build depends on: machine, CPU model and flags."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            cpu = "".join(l for l in f
                          if l.startswith(("model name", "flags")))
    except OSError:
        pass
    return "\n".join([platform.node(), platform.machine(), cpu])


def _compiler_id() -> str:
    try:
        r = subprocess.run([_CXX, "--version"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.splitlines()[0] if r.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _stamp() -> str:
    """Build key: sources' content, compiler, flags and host."""
    h = hashlib.sha256()
    for path in _SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(repr((_compiler_id(), _BASE_FLAGS, _FLAG_SETS)).encode())
    h.update(_host_id().encode())
    return h.hexdigest()[:20]


def _so_path(stamp: str) -> str:
    return os.path.join(_BUILD_DIR, f"j2k_native-{stamp}.so")


def _compile(so: str) -> Optional[str]:
    """Compile the library to `so`; returns None on success, else the
    compiler's message."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    err = ""
    for extra in _FLAG_SETS:
        cmd = [_CXX] + _BASE_FLAGS + extra + [_SRC, "-o", tmp]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
        except (OSError, subprocess.SubprocessError) as e:
            err = f"{' '.join(cmd)}: {e}"
            continue
        if r.returncode == 0:
            os.replace(tmp, so)
            for old in glob.glob(os.path.join(_BUILD_DIR, "j2k_native-*.so")):
                if old != so:
                    os.remove(old)
            return None
        err = f"{' '.join(cmd)}\n{r.stderr.strip()}"
    return err


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        so = _so_path(_stamp())
        if not os.path.exists(so):
            _build_error = _compile(so)
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(so)
            abi = lib.j2k_native_abi_version()
        except OSError as e:
            _build_error = f"loading {so}: {e}"
            return None
        if abi != 1:
            _build_error = f"{so}: ABI version {abi}, expected 1"
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.t1_encode_batch.restype = ctypes.c_int
        lib.t1_encode_batch.argtypes = [
            i32p, i64p, i32p, i32p, i32p, i32p, ctypes.c_int32,
            u8p, i64p, i32p, i32p, i32p, i32p,
            i32p, f64p, u8p, u8p, i32p, ctypes.c_int32]
        lib.t1_decode_batch.restype = ctypes.c_int
        lib.t1_decode_batch.argtypes = [
            u8p, i64p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
            i32p, i32p, ctypes.c_int32, i32p, i64p, ctypes.c_int32]
        lib.ht_encode_batch.restype = ctypes.c_int
        lib.ht_encode_batch.argtypes = [
            i32p, i64p, i32p, i32p, ctypes.c_int32,
            u8p, i64p, i32p, i32p, i32p, i32p, ctypes.c_int32]
        lib.ht_decode_batch.restype = ctypes.c_int
        lib.ht_decode_batch.argtypes = [
            u8p, i64p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, i32p, i64p, ctypes.c_int32]
        lib.ht_encode_refined_batch.restype = ctypes.c_int
        lib.ht_encode_refined_batch.argtypes = [
            i32p, i64p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
            u8p, i64p, i32p, i32p, i32p, i32p, i32p, i32p, f64p,
            ctypes.c_int32]
        lib.ht_decode_refined_batch.restype = ctypes.c_int
        lib.ht_decode_refined_batch.argtypes = [
            u8p, i64p, i32p, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int32, i32p, i64p, ctypes.c_int32]
        lib.mq_encode_streams_batch.restype = ctypes.c_int
        lib.mq_encode_streams_batch.argtypes = [
            u8p, i64p, ctypes.c_int32, u8p, i64p, i32p, ctypes.c_int32]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.ht_serialize_batch.restype = ctypes.c_int
        lib.ht_serialize_batch.argtypes = [
            u32p, i64p, i64p, i32p, i64p, i64p, i32p,
            i64p, i64p, i32p, i32p, ctypes.c_int32,
            u8p, i64p, i32p, ctypes.c_int32]
        lib.ht_t2_encode_frames.restype = ctypes.c_int
        lib.ht_t2_encode_frames.argtypes = [
            u32p, i64p, i64p, i32p, i64p, i64p, i32p,
            i64p, i64p, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, i32p, i32p, i32p, i32p, i32p, i32p,
            u8p, i64p, i64p, ctypes.c_int32]
        lib.ht_t2_decode_frames.restype = ctypes.c_int
        lib.ht_t2_decode_frames.argtypes = [
            u8p, i64p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, i32p, i32p, i32p, i32p, i32p, i32p,
            i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
            i32p, ctypes.c_int32]
        u32p_ = ctypes.POINTER(ctypes.c_uint32)
        lib.ht_t2_parse_frames.restype = ctypes.c_int
        lib.ht_t2_parse_frames.argtypes = [
            u8p, i64p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, i32p, i32p, i32p, i32p, i32p, i32p,
            i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
            u32p_, u32p_, i64p, i64p, i32p, i32p, ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def require() -> ctypes.CDLL:
    """The loaded library; raises NativeUnavailable with the compiler's or
    the loader's message when it cannot be built or loaded."""
    lib = _load()
    if lib is None:
        raise NativeUnavailable(f"native entropy library unavailable: "
                                f"{_build_error}")
    return lib


def _nthreads() -> int:
    return max(1, os.cpu_count() or 1)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def encode_blocks(jobs: Sequence[Tuple]) -> List[t1_py.T1EncodeResult]:
    """jobs: (coeffs int32 [h,w], band_name, cb_style)."""
    lib = require()
    n = len(jobs)
    if n == 0:
        return []
    coeff_offsets = np.zeros(n + 1, dtype=np.int64)
    ws = np.zeros(n, dtype=np.int32)
    hs = np.zeros(n, dtype=np.int32)
    bands = np.zeros(n, dtype=np.int32)
    styles = np.zeros(n, dtype=np.int32)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    for i, (c, band, style) in enumerate(jobs):
        h, w = c.shape
        ws[i], hs[i] = w, h
        bands[i] = BAND_CLASS[band]
        styles[i] = style
        coeff_offsets[i + 1] = coeff_offsets[i] + w * h
        # worst-case codeword capacity per block
        out_offsets[i + 1] = out_offsets[i] + (w * h * 6 + 4096)
    coeffs = np.empty(coeff_offsets[-1], dtype=np.int32)
    for i, (c, _, _) in enumerate(jobs):
        coeffs[coeff_offsets[i]:coeff_offsets[i + 1]] = \
            np.ascontiguousarray(c, dtype=np.int32).ravel()
    out_data = np.empty(out_offsets[-1], dtype=np.uint8)
    numbps = np.zeros(n, dtype=np.int32)
    npasses = np.zeros(n, dtype=np.int32)
    datalen = np.zeros(n, dtype=np.int32)
    nsegs = np.zeros(n, dtype=np.int32)
    rates = np.zeros(n * MAX_PASSES, dtype=np.int32)
    dists = np.zeros(n * MAX_PASSES, dtype=np.float64)
    terms = np.zeros(n * MAX_PASSES, dtype=np.uint8)
    types = np.zeros(n * MAX_PASSES, dtype=np.uint8)
    seg_lens = np.zeros(n * MAX_SEGS, dtype=np.int32)
    rc = lib.t1_encode_batch(
        _ptr(coeffs, ctypes.c_int32), _ptr(coeff_offsets, ctypes.c_int64),
        _ptr(ws, ctypes.c_int32), _ptr(hs, ctypes.c_int32),
        _ptr(bands, ctypes.c_int32), _ptr(styles, ctypes.c_int32), n,
        _ptr(out_data, ctypes.c_uint8), _ptr(out_offsets, ctypes.c_int64),
        _ptr(numbps, ctypes.c_int32), _ptr(npasses, ctypes.c_int32),
        _ptr(datalen, ctypes.c_int32), _ptr(nsegs, ctypes.c_int32),
        _ptr(rates, ctypes.c_int32), _ptr(dists, ctypes.c_double),
        _ptr(terms, ctypes.c_uint8), _ptr(types, ctypes.c_uint8),
        _ptr(seg_lens, ctypes.c_int32), _nthreads())
    if rc != 0:
        raise RuntimeError(f"native t1_encode_batch failed: {rc}")
    results: List[t1_py.T1EncodeResult] = []
    for i in range(n):
        np_ = int(npasses[i])
        passes = [t1_py.PassInfo(
            pass_type=int(types[i * MAX_PASSES + p]),
            bitplane=0,
            rate=int(rates[i * MAX_PASSES + p]),
            distortion=float(dists[i * MAX_PASSES + p]),
            terminated=bool(terms[i * MAX_PASSES + p]),
        ) for p in range(np_)]
        data = bytes(out_data[out_offsets[i]:out_offsets[i] + int(datalen[i])])
        segs = [int(seg_lens[i * MAX_SEGS + s]) for s in range(int(nsegs[i]))]
        results.append(t1_py.T1EncodeResult(
            data=data, num_bitplanes=int(numbps[i]), passes=passes,
            segment_lengths=segs))
    return results


def decode_blocks(jobs: Sequence[Tuple]) -> List[np.ndarray]:
    """jobs: (data, w, h, numbps, num_passes, band, cb_style, segment_lengths)."""
    lib = require()
    n = len(jobs)
    if n == 0:
        return []
    data_offsets = np.zeros(n + 1, dtype=np.int64)
    data_lens = np.zeros(n, dtype=np.int32)
    ws = np.zeros(n, dtype=np.int32)
    hs = np.zeros(n, dtype=np.int32)
    numbps = np.zeros(n, dtype=np.int32)
    numpasses = np.zeros(n, dtype=np.int32)
    bands = np.zeros(n, dtype=np.int32)
    styles = np.zeros(n, dtype=np.int32)
    seg_lens = np.zeros(n * MAX_SEGS, dtype=np.int32)
    seg_counts = np.zeros(n, dtype=np.int32)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    for i, (d, w, h, nb, np_, band, style, segs) in enumerate(jobs):
        data_offsets[i + 1] = data_offsets[i] + len(d)
        data_lens[i] = len(d)
        ws[i], hs[i] = w, h
        numbps[i] = nb
        numpasses[i] = np_
        bands[i] = BAND_CLASS[band]
        styles[i] = style
        segs = segs or []
        seg_counts[i] = len(segs)
        for s, ln in enumerate(segs[:MAX_SEGS]):
            seg_lens[i * MAX_SEGS + s] = ln
        out_offsets[i + 1] = out_offsets[i] + w * h
    all_data = np.empty(max(1, int(data_offsets[-1])), dtype=np.uint8)
    for i, (d, *_rest) in enumerate(jobs):
        if len(d):
            all_data[data_offsets[i]:data_offsets[i + 1]] = \
                np.frombuffer(d, dtype=np.uint8)
    out = np.zeros(max(1, int(out_offsets[-1])), dtype=np.int32)
    rc = lib.t1_decode_batch(
        _ptr(all_data, ctypes.c_uint8), _ptr(data_offsets, ctypes.c_int64),
        _ptr(data_lens, ctypes.c_int32),
        _ptr(ws, ctypes.c_int32), _ptr(hs, ctypes.c_int32),
        _ptr(numbps, ctypes.c_int32), _ptr(numpasses, ctypes.c_int32),
        _ptr(bands, ctypes.c_int32), _ptr(styles, ctypes.c_int32),
        _ptr(seg_lens, ctypes.c_int32), _ptr(seg_counts, ctypes.c_int32),
        n, _ptr(out, ctypes.c_int32), _ptr(out_offsets, ctypes.c_int64),
        _nthreads())
    if rc != 0:
        raise RuntimeError(f"native t1_decode_batch failed: {rc}")
    results = []
    for i, (d, w, h, *_rest) in enumerate(jobs):
        results.append(out[out_offsets[i]:out_offsets[i + 1]]
                       .reshape(h, w).copy())
    return results


def ht_encode_blocks(jobs: Sequence[np.ndarray]):
    """jobs: list of int32 [h, w] coefficient blocks.
    Returns list of (segment_bytes, numbps, umax)."""
    lib = require()
    n = len(jobs)
    if n == 0:
        return []
    coeff_offsets = np.zeros(n + 1, dtype=np.int64)
    ws = np.zeros(n, dtype=np.int32)
    hs = np.zeros(n, dtype=np.int32)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    for i, c in enumerate(jobs):
        h, w = c.shape
        ws[i], hs[i] = w, h
        coeff_offsets[i + 1] = coeff_offsets[i] + w * h
        out_offsets[i + 1] = out_offsets[i] + (w * h * 6 + 4096)
    coeffs = np.empty(coeff_offsets[-1], dtype=np.int32)
    for i, c in enumerate(jobs):
        coeffs[coeff_offsets[i]:coeff_offsets[i + 1]] = \
            np.ascontiguousarray(c, dtype=np.int32).ravel()
    out_data = np.empty(out_offsets[-1], dtype=np.uint8)
    numbps = np.zeros(n, dtype=np.int32)
    umax = np.zeros(n, dtype=np.int32)
    datalen = np.zeros(n, dtype=np.int32)
    dummy = np.zeros(1, dtype=np.int32)
    rc = lib.ht_encode_batch(
        _ptr(coeffs, ctypes.c_int32), _ptr(coeff_offsets, ctypes.c_int64),
        _ptr(ws, ctypes.c_int32), _ptr(hs, ctypes.c_int32), n,
        _ptr(out_data, ctypes.c_uint8), _ptr(out_offsets, ctypes.c_int64),
        _ptr(numbps, ctypes.c_int32), _ptr(umax, ctypes.c_int32),
        _ptr(datalen, ctypes.c_int32), _ptr(dummy, ctypes.c_int32),
        _nthreads())
    if rc != 0:
        raise RuntimeError(f"native ht_encode_batch failed: {rc}")
    return [(bytes(out_data[out_offsets[i]:out_offsets[i] + int(datalen[i])]),
             int(numbps[i]), int(umax[i])) for i in range(n)]


def ht_decode_blocks(jobs: Sequence[Tuple]):
    """jobs: (data_bytes, w, h, numbps).  Returns list of int32 [h, w]."""
    lib = require()
    n = len(jobs)
    if n == 0:
        return []
    data_offsets = np.zeros(n + 1, dtype=np.int64)
    data_lens = np.zeros(n, dtype=np.int32)
    ws = np.zeros(n, dtype=np.int32)
    hs = np.zeros(n, dtype=np.int32)
    numbps = np.zeros(n, dtype=np.int32)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    for i, (d, w, h, nb) in enumerate(jobs):
        data_offsets[i + 1] = data_offsets[i] + len(d)
        data_lens[i] = len(d)
        ws[i], hs[i] = w, h
        numbps[i] = nb
        out_offsets[i + 1] = out_offsets[i] + w * h
    all_data = np.empty(max(1, int(data_offsets[-1])), dtype=np.uint8)
    for i, (d, *_r) in enumerate(jobs):
        if len(d):
            all_data[data_offsets[i]:data_offsets[i + 1]] = \
                np.frombuffer(bytes(d), dtype=np.uint8)
    out = np.zeros(max(1, int(out_offsets[-1])), dtype=np.int32)
    rc = lib.ht_decode_batch(
        _ptr(all_data, ctypes.c_uint8), _ptr(data_offsets, ctypes.c_int64),
        _ptr(data_lens, ctypes.c_int32),
        _ptr(ws, ctypes.c_int32), _ptr(hs, ctypes.c_int32),
        _ptr(numbps, ctypes.c_int32),
        n, _ptr(out, ctypes.c_int32), _ptr(out_offsets, ctypes.c_int64),
        _nthreads())
    if rc != 0:
        raise RuntimeError(f"native ht_decode_batch failed: {rc}")
    return [out[out_offsets[i]:out_offsets[i + 1]].reshape(jobs[i][2], jobs[i][1]).copy()
            for i in range(n)]


def ht_encode_refined_blocks(jobs: Sequence[np.ndarray],
                             require_exact: bool = True):
    """jobs: list of int32 [h, w] blocks.  Returns per block
    (data, numbps, lcup, lspp, lref, refined, (d_total, resid_cup,
    resid_spp, resid_mrp)) — data = cleanup ++ spp ++ mrp when refined,
    plain cleanup segment otherwise.  Byte-identical to
    ops/ht.encode_refined (tests/test_ht_refinement.py)."""
    lib = require()
    n = len(jobs)
    if n == 0:
        return []
    coeff_offsets = np.zeros(n + 1, dtype=np.int64)
    ws = np.zeros(n, dtype=np.int32)
    hs = np.zeros(n, dtype=np.int32)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    for i, c in enumerate(jobs):
        h, w = c.shape
        ws[i], hs[i] = w, h
        coeff_offsets[i + 1] = coeff_offsets[i] + w * h
        out_offsets[i + 1] = out_offsets[i] + (w * h * 8 + 8192)
    coeffs = np.empty(max(1, int(coeff_offsets[-1])), dtype=np.int32)
    for i, c in enumerate(jobs):
        coeffs[coeff_offsets[i]:coeff_offsets[i + 1]] = \
            np.ascontiguousarray(c, dtype=np.int32).ravel()
    out_data = np.empty(int(out_offsets[-1]), dtype=np.uint8)
    numbps = np.zeros(n, dtype=np.int32)
    umax = np.zeros(n, dtype=np.int32)
    lcup = np.zeros(n, dtype=np.int32)
    lspp = np.zeros(n, dtype=np.int32)
    lref = np.zeros(n, dtype=np.int32)
    refined = np.zeros(n, dtype=np.int32)
    dist = np.zeros(n * 4, dtype=np.float64)
    rc = lib.ht_encode_refined_batch(
        _ptr(coeffs, ctypes.c_int32), _ptr(coeff_offsets, ctypes.c_int64),
        _ptr(ws, ctypes.c_int32), _ptr(hs, ctypes.c_int32), n,
        1 if require_exact else 0,
        _ptr(out_data, ctypes.c_uint8), _ptr(out_offsets, ctypes.c_int64),
        _ptr(numbps, ctypes.c_int32), _ptr(umax, ctypes.c_int32),
        _ptr(lcup, ctypes.c_int32), _ptr(lspp, ctypes.c_int32),
        _ptr(lref, ctypes.c_int32), _ptr(refined, ctypes.c_int32),
        _ptr(dist, ctypes.c_double), _nthreads())
    if rc != 0:
        raise RuntimeError(f"native ht_encode_refined_batch failed: {rc}")
    out = []
    for i in range(n):
        total = int(lcup[i]) + int(lref[i])
        data = bytes(out_data[out_offsets[i]:out_offsets[i] + total])
        out.append((data, int(numbps[i]), int(lcup[i]), int(lspp[i]),
                    int(lref[i]), bool(refined[i]),
                    tuple(float(dist[i * 4 + k]) for k in range(4))))
    return out


def ht_decode_refined_blocks(jobs: Sequence[Tuple]):
    """jobs: (data, w, h, numbps, num_passes, lcup, lref).
    Returns list of int32 [h, w] (truncation-aware, scaled)."""
    lib = require()
    n = len(jobs)
    if n == 0:
        return []
    data_offsets = np.zeros(n + 1, dtype=np.int64)
    lcup = np.zeros(n, dtype=np.int32)
    lref = np.zeros(n, dtype=np.int32)
    ws = np.zeros(n, dtype=np.int32)
    hs = np.zeros(n, dtype=np.int32)
    numbps = np.zeros(n, dtype=np.int32)
    npass = np.zeros(n, dtype=np.int32)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    for i, (d, w, h, nb, np_, lc, lr) in enumerate(jobs):
        data_offsets[i + 1] = data_offsets[i] + len(d)
        ws[i], hs[i] = w, h
        numbps[i] = nb
        npass[i] = np_
        lcup[i] = lc
        lref[i] = lr
        out_offsets[i + 1] = out_offsets[i] + w * h
    all_data = np.empty(max(1, int(data_offsets[-1])), dtype=np.uint8)
    for i, (d, *_r) in enumerate(jobs):
        if len(d):
            all_data[data_offsets[i]:data_offsets[i + 1]] = \
                np.frombuffer(bytes(d), dtype=np.uint8)
    out = np.zeros(max(1, int(out_offsets[-1])), dtype=np.int32)
    rc = lib.ht_decode_refined_batch(
        _ptr(all_data, ctypes.c_uint8), _ptr(data_offsets, ctypes.c_int64),
        _ptr(lcup, ctypes.c_int32), _ptr(lref, ctypes.c_int32),
        _ptr(ws, ctypes.c_int32), _ptr(hs, ctypes.c_int32),
        _ptr(numbps, ctypes.c_int32), _ptr(npass, ctypes.c_int32),
        n, _ptr(out, ctypes.c_int32), _ptr(out_offsets, ctypes.c_int64),
        _nthreads())
    if rc != 0:
        raise RuntimeError(f"native ht_decode_refined_batch failed: {rc}")
    return [out[out_offsets[i]:out_offsets[i + 1]]
            .reshape(jobs[i][2], jobs[i][1]).copy() for i in range(n)]


def mq_encode_streams(streams: Sequence[bytes]):
    """MQ-code packed decision streams (ctx | bit<<5 per byte) to codeword
    segments — the host half of the hybrid device-decisions + host-MQ
    EBCOT path (byte-identical to ops/mq.MQEncoder over the same
    decisions)."""
    lib = require()
    n = len(streams)
    if n == 0:
        return []
    dec_off = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(streams):
        dec_off[i + 1] = dec_off[i] + len(s)
    buf = np.empty(max(1, int(dec_off[-1])), dtype=np.uint8)
    for i, s in enumerate(streams):
        if len(s):
            buf[dec_off[i]:dec_off[i + 1]] = np.frombuffer(bytes(s), np.uint8)
    out_off = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(streams):
        out_off[i + 1] = out_off[i] + (len(s) // 2 + 64)
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    rc = lib.mq_encode_streams_batch(
        _ptr(buf, ctypes.c_uint8), _ptr(dec_off, ctypes.c_int64), n,
        _ptr(out, ctypes.c_uint8), _ptr(out_off, ctypes.c_int64),
        _ptr(lens, ctypes.c_int32), _nthreads())
    if rc != 0:
        raise RuntimeError(f"native mq_encode_streams_batch failed: {rc}")
    return [bytes(out[out_off[i]:out_off[i] + int(lens[i])])
            for i in range(n)]


def ht_serialize_blocks(words: np.ndarray,
                        ms_off: np.ndarray, ms_nw: np.ndarray,
                        ms_bits: np.ndarray,
                        vlc_off: np.ndarray, vlc_nw: np.ndarray,
                        vlc_bits: np.ndarray,
                        mel_off: np.ndarray, mel_nw: np.ndarray,
                        mel_bits: np.ndarray,
                        numbps: np.ndarray) -> List[bytes]:
    """Assemble HT cleanup segments from the device field kernel's packed
    streams (ops/ht_tpu.py).  `words` is the flat uint32 stream pool;
    per-block stream i lives at words[off[i] : off[i]+nw[i]].

    Returns per-block segment bytes (b"" where numbps == 0)."""
    lib = require()
    n = len(numbps)
    if n == 0:
        return []
    words = np.ascontiguousarray(words, dtype=np.uint32)
    ms_bits = np.ascontiguousarray(ms_bits, dtype=np.int32)
    vlc_bits = np.ascontiguousarray(vlc_bits, dtype=np.int32)
    mel_bits = np.ascontiguousarray(mel_bits, dtype=np.int32)
    numbps = np.ascontiguousarray(numbps, dtype=np.int32)
    caps = (ms_bits.astype(np.int64) // 7 + vlc_bits.astype(np.int64) // 7
            + mel_bits.astype(np.int64) + 32)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(caps, out=out_offsets[1:])
    out_data = np.empty(int(out_offsets[-1]), dtype=np.uint8)
    out_len = np.zeros(n, dtype=np.int32)

    def p64(a):
        return _ptr(np.ascontiguousarray(a, dtype=np.int64), ctypes.c_int64)

    rc = lib.ht_serialize_batch(
        _ptr(words, ctypes.c_uint32),
        p64(ms_off), p64(ms_nw), _ptr(ms_bits, ctypes.c_int32),
        p64(vlc_off), p64(vlc_nw), _ptr(vlc_bits, ctypes.c_int32),
        p64(mel_off), p64(mel_nw), _ptr(mel_bits, ctypes.c_int32),
        _ptr(numbps, ctypes.c_int32), n,
        _ptr(out_data, ctypes.c_uint8), _ptr(out_offsets, ctypes.c_int64),
        _ptr(out_len, ctypes.c_int32), _nthreads())
    if rc != 0:
        raise RuntimeError(f"native ht_serialize_batch failed: {rc}")
    return [bytes(out_data[out_offsets[i]:out_offsets[i] + int(out_len[i])])
            for i in range(n)]


def ht_t2_encode_frames(words: np.ndarray,
                        ms_off, ms_nw, ms_bits,
                        vlc_off, vlc_nw, vlc_bits,
                        mel_off, mel_nw, mel_bits,
                        numbps: np.ndarray, zbp: np.ndarray,
                        n_frames: int, nb: int, geom) -> List[bytes]:
    """Fused segment serialization + single-layer T2 packet assembly.

    `geom` is the dict from models/fused_encode.py::t2_geom (packet walk in
    progression order).  Returns per-frame tile-body bytes (packets only; the
    caller wraps SOT/SOD)."""
    lib = require()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    numbps = np.ascontiguousarray(numbps, dtype=np.int32)
    zbp = np.ascontiguousarray(zbp, dtype=np.int32)
    ms_bits = np.ascontiguousarray(ms_bits, dtype=np.int32)
    vlc_bits = np.ascontiguousarray(vlc_bits, dtype=np.int32)
    mel_bits = np.ascontiguousarray(mel_bits, dtype=np.int32)
    # per-frame capacity: stuffed stream bytes + header overhead
    per_block = (ms_bits.astype(np.int64) // 7 + vlc_bits.astype(np.int64) // 7
                 + mel_bits.astype(np.int64) + 48)
    caps = per_block.reshape(n_frames, nb).sum(axis=1) \
        + int(geom["n_packets"]) * 16 + 1024
    out_offsets = np.zeros(n_frames + 1, dtype=np.int64)
    np.cumsum(caps, out=out_offsets[1:])
    out = np.empty(int(out_offsets[-1]), dtype=np.uint8)
    out_lens = np.zeros(n_frames, dtype=np.int64)

    def p64(a):
        return _ptr(np.ascontiguousarray(a, dtype=np.int64), ctypes.c_int64)

    rc = lib.ht_t2_encode_frames(
        _ptr(words, ctypes.c_uint32),
        p64(ms_off), p64(ms_nw), _ptr(ms_bits, ctypes.c_int32),
        p64(vlc_off), p64(vlc_nw), _ptr(vlc_bits, ctypes.c_int32),
        p64(mel_off), p64(mel_nw), _ptr(mel_bits, ctypes.c_int32),
        _ptr(numbps, ctypes.c_int32), _ptr(zbp, ctypes.c_int32),
        n_frames, nb,
        int(geom["n_packets"]), _ptr(geom["pkt_nbp"], ctypes.c_int32),
        _ptr(geom["bp_cbw"], ctypes.c_int32),
        _ptr(geom["bp_cbh"], ctypes.c_int32),
        _ptr(geom["bp_nblocks"], ctypes.c_int32),
        _ptr(geom["bp_blocks"], ctypes.c_int32),
        _ptr(geom["bp_block_xy"], ctypes.c_int32),
        _ptr(out, ctypes.c_uint8), _ptr(out_offsets, ctypes.c_int64),
        _ptr(out_lens, ctypes.c_int64), _nthreads())
    if rc != 0:
        raise RuntimeError(f"native ht_t2_encode_frames failed: {rc}")
    return [bytes(out[out_offsets[f]:out_offsets[f] + int(out_lens[f])])
            for f in range(n_frames)]


def ht_t2_decode_frames(data: np.ndarray, frame_off: np.ndarray,
                        n_frames: int, nb: int, geom,
                        mb: np.ndarray, ws: np.ndarray, hs: np.ndarray,
                        cbh: int, cbw: int) -> Optional[np.ndarray]:
    """Fused single-layer T2 parse + HT block decode.

    Returns coefficients [n_frames, nb, cbh, cbw] int32 (padded slots), or
    None when a stream needs the general path (npasses != 1, truncation)."""
    lib = require()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    frame_off = np.ascontiguousarray(frame_off, dtype=np.int64)
    coeffs = np.empty((n_frames, nb, cbh, cbw), dtype=np.int32)
    rc = lib.ht_t2_decode_frames(
        _ptr(data, ctypes.c_uint8), _ptr(frame_off, ctypes.c_int64),
        n_frames, nb,
        int(geom["n_packets"]), _ptr(geom["pkt_nbp"], ctypes.c_int32),
        _ptr(geom["bp_cbw"], ctypes.c_int32),
        _ptr(geom["bp_cbh"], ctypes.c_int32),
        _ptr(geom["bp_nblocks"], ctypes.c_int32),
        _ptr(geom["bp_blocks"], ctypes.c_int32),
        _ptr(geom["bp_block_xy"], ctypes.c_int32),
        _ptr(np.ascontiguousarray(mb, dtype=np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(ws, dtype=np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(hs, dtype=np.int32), ctypes.c_int32),
        cbh, cbw, _ptr(coeffs, ctypes.c_int32), _nthreads())
    if rc != 0:
        return None
    return coeffs


def ht_t2_parse_frames(data: np.ndarray, frame_off: np.ndarray,
                       n_frames: int, nb: int, geom,
                       mb: np.ndarray, ws: np.ndarray, hs: np.ndarray,
                       cbh: int, cbw: int):
    """Fused single-layer T2 parse + HT VLC-phase parse for the DEVICE
    decode path: host runs MEL/CxtVLC/UVLC (sequentially coupled), device
    extracts MagSgn + dequantizes + inverse-DWTs (ops/ht_tpu_decode.py).

    Returns (qinfo uint32 [n_frames*nb, qh, qw], mag_pool uint32 [P],
    mag_woff int64 [n_frames*nb], mag_nw int32 [n_frames*nb],
    numbps int32 [n_frames*nb]), or None when a stream needs the general
    path."""
    lib = require()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    frame_off = np.ascontiguousarray(frame_off, dtype=np.int64)
    qw_pad, qh_pad = (cbw + 1) // 2, (cbh + 1) // 2
    qinfo = np.empty((n_frames * nb, qh_pad, qw_pad), dtype=np.uint32)
    # per-frame pool regions: unstuffed magsgn bits <= 8 * frame bytes
    frame_bytes = np.diff(frame_off)
    caps = (frame_bytes * 8 + 31) // 32 + nb
    pool_off = np.zeros(n_frames + 1, dtype=np.int64)
    np.cumsum(caps, out=pool_off[1:])
    mag_pool = np.zeros(int(pool_off[-1]) + 2, dtype=np.uint32)
    mag_woff = np.empty(n_frames * nb, dtype=np.int64)
    mag_nw = np.empty(n_frames * nb, dtype=np.int32)
    numbps = np.empty(n_frames * nb, dtype=np.int32)
    rc = lib.ht_t2_parse_frames(
        _ptr(data, ctypes.c_uint8), _ptr(frame_off, ctypes.c_int64),
        n_frames, nb,
        int(geom["n_packets"]), _ptr(geom["pkt_nbp"], ctypes.c_int32),
        _ptr(geom["bp_cbw"], ctypes.c_int32),
        _ptr(geom["bp_cbh"], ctypes.c_int32),
        _ptr(geom["bp_nblocks"], ctypes.c_int32),
        _ptr(geom["bp_blocks"], ctypes.c_int32),
        _ptr(geom["bp_block_xy"], ctypes.c_int32),
        _ptr(np.ascontiguousarray(mb, dtype=np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(ws, dtype=np.int32), ctypes.c_int32),
        _ptr(np.ascontiguousarray(hs, dtype=np.int32), ctypes.c_int32),
        cbh, cbw,
        _ptr(qinfo, ctypes.c_uint32), _ptr(mag_pool, ctypes.c_uint32),
        _ptr(pool_off, ctypes.c_int64), _ptr(mag_woff, ctypes.c_int64),
        _ptr(mag_nw, ctypes.c_int32), _ptr(numbps, ctypes.c_int32),
        _nthreads())
    if rc != 0:
        return None
    return qinfo, mag_pool, mag_woff, mag_nw, numbps
