"""Entropy backend dispatch: native (C++) batch coder vs Python oracle.

The reference parallelizes block coding with a goroutine pool
(/root/reference/encoder.go:690-742); here the batch boundary is explicit so
the native backend can thread across code-blocks, and the Python oracle stays
available for differential testing (the reference's EncodeSafe/EncodeFast5
pattern, t1.go:918-923).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops import t1


def _use_native(backend: str) -> bool:
    """Every backend but "python" codes blocks natively; a library that
    cannot be built raises (loader.NativeUnavailable) instead of silently
    dropping to the Python oracle."""
    if backend == "python":
        return False
    from ..native import loader
    loader.require()
    return True


def _encode_ht(job, refinement: bool = False,
               require_exact: bool = True) -> t1.T1EncodeResult:
    from ..ops import ht
    import numpy as np
    coeffs = job[0]
    mb = job[3]
    if refinement:
        res = _encode_ht_refined(coeffs, require_exact)
        if res is not None:
            return res
    seg, numbps, u_max = ht.encode_cleanup(coeffs)
    if numbps == 0:
        return t1.T1EncodeResult(b"", 0, [], [])
    dist = float((np.abs(coeffs).astype(np.float64) ** 2).sum())
    p = t1.PassInfo(pass_type=2, bitplane=0, rate=len(seg), distortion=dist,
                    terminated=True)
    # HT cleanup-only signalling: the decoder's bitplane shift is
    # p = B + 1 - zbp and full-precision decode requires p == 1, so the
    # packet signals numbps = 1 (zbp = Mb - 1) for every HT block
    # (empirically pinned against OpenJPEG; U_q <= zbp + 1 needs the extra
    # guard bit the header writes for HT).
    return t1.T1EncodeResult(seg, 1, [p], [len(seg)])


def _encode_ht_refined(coeffs, require_exact: bool):
    """Try the 3-pass HT set (cleanup at shift 1, SigProp+MagRef at bit 0),
    which gives PCRD three truncation points per block.  Returns None when
    the block should use a cleanup-only set instead (nothing to refine, or
    the set would lose isolated odd units and exactness is required)."""
    from ..ops import ht
    import numpy as np
    c = np.asarray(coeffs, dtype=np.int64)
    mags = np.abs(c)
    if mags.size == 0 or int(mags.max()) <= 1:
        return None
    halved_sig = (mags >> 1) != 0
    n_m, n_new, n_lost = ht.sigprop_stats(c, halved_sig.astype(np.uint8))
    if n_lost and require_exact:
        return None
    cup, spp, mrp, numbps, u_max = ht.encode_refined(c)
    if numbps < 2:
        return None
    data = cup + spp + mrp
    odd = (mags & 1).astype(np.float64)
    d_total = float((mags.astype(np.float64) ** 2).sum())
    # residual energy after each pass (decoder reconstruction model)
    resid_cup = float((odd[halved_sig] ** 2).sum()) \
        + float((mags[~halved_sig].astype(np.float64) ** 2).sum())
    resid_spp = resid_cup - float(n_new)          # new significants exact
    resid_mrp = float(n_lost)                     # only unreachable units left
    passes = [
        t1.PassInfo(2, 1, len(cup), d_total - resid_cup, True),
        t1.PassInfo(0, 0, len(cup) + len(spp), d_total - resid_spp, False),
        t1.PassInfo(1, 0, len(data), d_total - resid_mrp, True),
    ]
    return t1.T1EncodeResult(data, numbps, passes,
                             [len(cup), len(spp) + len(mrp)])


def encode_blocks_batch(jobs: Sequence[Tuple], backend: str = "auto",
                        ht_refinement: bool = False,
                        ht_require_exact: bool = True,
                        exact_rates: bool = True
                        ) -> List[t1.T1EncodeResult]:
    """jobs: (coeffs int32 [h,w], band_name, cb_style, mb) per block.

    exact_rates=False lets the native EBCOT coder skip the exact D.4.1
    truncation-length computation (monotone upper bounds instead) — used
    when nothing consumes pass rates (single layer, no rate budget)."""
    from ..utils import markers as mk
    if jobs and (jobs[0][2] & mk.CBSTYLE_HT):
        use_native = _use_native(backend)
        if use_native and not ht_refinement:
            from ..native import loader
            import numpy as np
            res = loader.ht_encode_blocks([j[0] for j in jobs])
            out = []
            for (seg, numbps, umax), j in zip(res, jobs):
                if numbps == 0:
                    out.append(t1.T1EncodeResult(b"", 0, [], []))
                    continue
                dist = float((np.abs(j[0]).astype(np.float64) ** 2).sum())
                p = t1.PassInfo(2, 0, len(seg), dist, True)
                out.append(t1.T1EncodeResult(seg, 1, [p], [len(seg)]))
            return out
        if use_native and ht_refinement:
            from ..native import loader
            import numpy as np
            res = loader.ht_encode_refined_blocks(
                [j[0] for j in jobs], require_exact=ht_require_exact)
            out = []
            for (data, numbps, lc, lspp, lref, refined, dist), j in \
                    zip(res, jobs):
                if numbps == 0:
                    out.append(t1.T1EncodeResult(b"", 0, [], []))
                    continue
                if not refined:
                    d = float((np.abs(j[0]).astype(np.float64) ** 2).sum())
                    p = t1.PassInfo(2, 0, len(data), d, True)
                    out.append(t1.T1EncodeResult(data, 1, [p], [len(data)]))
                    continue
                d_total, resid_cup, resid_spp, resid_mrp = dist
                passes = [
                    t1.PassInfo(2, 1, lc, d_total - resid_cup, True),
                    t1.PassInfo(0, 0, lc + lspp, d_total - resid_spp, False),
                    t1.PassInfo(1, 0, lc + lref, d_total - resid_mrp, True),
                ]
                out.append(t1.T1EncodeResult(data, numbps, passes,
                                             [lc, lref]))
            return out
        return [_encode_ht(j, refinement=ht_refinement,
                           require_exact=ht_require_exact) for j in jobs]
    use_native = _use_native(backend)
    if use_native:
        from ..native import loader
        sty_extra = 0 if exact_rates else loader.STY_FAST_RATES
        return loader.encode_blocks([(j[0], j[1], j[2] | sty_extra)
                                     for j in jobs])
    return [t1.encode_block(j[0], j[1], cb_style=j[2]) for j in jobs]


def decode_blocks_batch(jobs: Sequence[Tuple], backend: str = "auto"
                        ) -> List[np.ndarray]:
    """jobs: (data, w, h, numbps, num_passes, band, cb_style, segment_lengths)."""
    from ..utils import markers as mk
    if jobs and (jobs[0][6] & mk.CBSTYLE_HT):
        use_native = _use_native(backend)
        refined = any(j[4] > 1 for j in jobs)
        if use_native and not refined:
            from ..native import loader
            return loader.ht_decode_blocks(
                [(bytes(j[0]), j[1], j[2], j[3]) for j in jobs])
        if use_native and refined:
            from ..native import loader
            njobs = []
            for j in jobs:
                d = bytes(j[0])
                segs = list(j[7] or [])
                lc = min(segs[0] if segs else len(d), len(d))
                lr = min(segs[1] if len(segs) > 1 else 0, len(d) - lc)
                njobs.append((d, j[1], j[2], j[3], j[4], lc, lr))
            return loader.ht_decode_refined_blocks(njobs)
        from ..ops import ht
        return [ht.decode_ht_block(bytes(j[0]), j[1], j[2], j[3],
                                   num_passes=j[4], segment_lengths=list(j[7]))
                for j in jobs]
    use_native = _use_native(backend)
    if use_native:
        from ..native import loader
        return loader.decode_blocks(jobs)
    return [t1.decode_block(*j) for j in jobs]
