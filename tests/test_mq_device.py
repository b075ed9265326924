"""Differential tests for the lockstep device MQ coder (ops/mq_device.py)
and the fused device EBCOT path (models/ebcot_fused.py).

The contract under test (mq_device docstring): feeding the same decision
stream through ops/mq.MQEncoder yields byte-identical segments, and the
full fused path (decision kernel + lockstep MQ + pool compaction) matches
the standard host encoder's codestream bytes exactly.

Reference behavior: /root/reference/internal/entropy/mqc.go:168-341 (the
serial coder both implementations must reproduce).
"""
import numpy as np
import pytest

from go_jpeg2000_tpu.ops import mq as mq_ref
from go_jpeg2000_tpu.ops import mq_device


def _oracle_segment(stream):
    """MQEncoder over a (ctx, bit) stream -> flushed segment bytes."""
    enc = mq_ref.MQEncoder()
    for ctx, bit in stream:
        enc.encode(bit, ctx)
    return enc.flush()


def _device_segments(streams, t_cap):
    """Run the exact fused-path sequence: pack -> compact -> scan ->
    row-compact -> pool; slice per-lane segments and strip trailing 0xFF
    (the host-side strip in ebcot_fused.fetch_results)."""
    B = len(streams)
    U = mq_device.UNROLL
    assert t_cap % U == 0
    slots = np.full((B, t_cap), 255, np.uint8)   # EMPTY-ish filler
    valid = np.zeros((B, t_cap), bool)
    for i, s in enumerate(streams):
        for j, (ctx, bit) in enumerate(s):
            slots[i, j] = ctx | (bit << 5)
            valid[i, j] = True
    ndec = np.asarray([len(s) for s in streams], np.int32)
    import jax.numpy as jnp
    aligned = mq_device.compact_rows(jnp.asarray(slots), jnp.asarray(valid),
                                     t_cap)
    steps = t_cap // U
    xs_tm = aligned.T.reshape(steps, U, B)
    sb, sv, lens = mq_device.mq_encode_scan(xs_tm, jnp.asarray(ndec))
    rows = mq_device.compact_rows(sb, sv, 2 * t_cap + 8, drop_first=True)
    cap_pool = int(np.asarray(lens).sum()) + 64
    pool = np.asarray(mq_device.pool_rows(rows, lens, cap_pool))
    lens = np.asarray(lens)
    ends = np.cumsum(lens)
    offs = ends - lens
    segs = []
    for i in range(B):
        seg = bytes(pool[offs[i]:ends[i]])
        if seg and seg[-1] == 0xFF:
            seg = seg[:-1]
        segs.append(seg)
    return segs


def test_mq_scan_byte_identical_random_streams():
    """Random decision streams across lanes, varied lengths (incl. empty and
    single-decision lanes): device segments == MQEncoder segments."""
    rng = np.random.RandomState(7)
    streams = []
    lengths = [0, 1, 2, 7, 8, 9, 40, 100, 256, 333, 512]
    for i, n in enumerate(lengths):
        streams.append([(int(rng.randint(0, 19)), int(rng.randint(0, 2)))
                        for _ in range(n)])
    t_cap = 512
    segs = _device_segments(streams, t_cap)
    for s, seg in zip(streams, segs):
        if not s:
            assert seg == b""
            continue
        assert seg == _oracle_segment(s)


def test_mq_scan_skewed_streams():
    """Heavily-skewed streams exercise the carry/stuffing paths: long MPS
    runs drive A small and force dense byteouts; alternating LPS hits the
    switch path; all-one bits on the UNI context stress 0xFF stuffing."""
    streams = [
        [(0, 0)] * 300,                          # long MPS run, ctx 0
        [(18, 1)] * 300,                         # UNI all-ones (0xFF chains)
        [(17, i % 2) for i in range(300)],       # RL alternating (LPS storm)
        [(9, 1)] * 150 + [(9, 0)] * 150,         # SC flip mid-stream
        [(i % 19, (i // 3) % 2) for i in range(431)],
    ]
    segs = _device_segments(streams, 440)
    for s, seg in zip(streams, segs):
        assert seg == _oracle_segment(s), "skewed stream mismatch"


def test_encode_batch_device_matches_host_and_roundtrips():
    """encode_batch(backend='device') on CPU: codestream must round-trip
    pixel-exact AND be byte-identical to the host backend's output."""
    from go_jpeg2000_tpu.models.encoder import encode_batch
    from go_jpeg2000_tpu.models.decoder import decode_batch
    from go_jpeg2000_tpu.options import Format, Options

    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, size=(96, 96)).astype(np.float32)
    for ax in (0, 1):
        img = (img + np.roll(img, 1, axis=ax)) / 2
    frames = [img.astype(np.uint8), (255 - img).astype(np.uint8)]

    dev_opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                       high_throughput=False, backend="device")
    host_opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                        high_throughput=False, backend="python")
    dev_streams = encode_batch(frames, dev_opts)
    host_streams = encode_batch(frames, host_opts)
    assert len(dev_streams) == len(frames)
    for d, h in zip(dev_streams, host_streams):
        assert d == h, "device codestream differs from host codestream"
    decs = decode_batch(dev_streams)
    for dec, f in zip(decs, frames):
        assert np.array_equal(dec, f)


def test_encode_batch_hybrid_matches_host_and_roundtrips():
    """backend='hybrid' (ablation path B: device decision kernel + native
    host MQ over the pooled decision streams) must be byte-identical to the
    host backend and round-trip pixel-exact — the composition backend='auto'
    ships on local-PCIe links (VERDICT r4 next #5)."""
    from go_jpeg2000_tpu.native import loader
    if not loader.available():
        pytest.skip("native unavailable")
    from go_jpeg2000_tpu.models.encoder import encode_batch
    from go_jpeg2000_tpu.models.decoder import decode_batch
    from go_jpeg2000_tpu.options import Format, Options

    rng = np.random.RandomState(11)
    img = rng.randint(0, 256, size=(96, 96)).astype(np.float32)
    for ax in (0, 1):
        img = (img + np.roll(img, 1, axis=ax)) / 2
    frames = [img.astype(np.uint8), (255 - img).astype(np.uint8)]

    hyb_opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                       high_throughput=False, backend="hybrid")
    host_opts = Options(format=Format.J2K, lossless=True, num_resolutions=3,
                        high_throughput=False, backend="python")
    hyb_streams = encode_batch(frames, hyb_opts)
    host_streams = encode_batch(frames, host_opts)
    for d, h in zip(hyb_streams, host_streams):
        assert d == h, "hybrid codestream differs from host codestream"
    decs = decode_batch(hyb_streams)
    for dec, f in zip(decs, frames):
        assert np.array_equal(dec, f)


@pytest.mark.parametrize("path,counter", [
    ("device", "enc.ebcot_device_frames"),
    ("hybrid", "enc.ebcot_hybrid_frames"),
    ("host", "enc.device_transform_frames"),
])
def test_auto_ebcot_takes_recorded_winner(monkeypatch, path, counter):
    """backend='auto' takes encoder.AUTO_EBCOT_PATH on every platform —
    no probe, no platform test — and every path yields the host coder's
    bytes."""
    from go_jpeg2000_tpu.models import encoder
    from go_jpeg2000_tpu.options import Format, Options
    from go_jpeg2000_tpu.utils.metrics import counters

    rng = np.random.RandomState(7)
    frames = [rng.randint(0, 256, size=(64, 64)).astype(np.uint8)
              for _ in range(2)]

    def opts(backend):
        return Options(format=Format.J2K, lossless=True, num_resolutions=3,
                       high_throughput=False, backend=backend)

    monkeypatch.setattr(encoder, "AUTO_EBCOT_PATH", path)
    names = ("enc.ebcot_device_frames", "enc.ebcot_hybrid_frames",
             "enc.device_transform_frames")
    before = {k: counters.get(k) for k in names}
    streams = encoder.encode_batch(frames, opts("auto"))
    ran = {k: counters.get(k) - before[k] for k in names}
    assert ran == {k: (len(frames) if k == counter else 0) for k in names}
    assert streams == encoder.encode_batch(frames, opts("python"))


def test_encode_batch_device_16bit_falls_back():
    """Bit depths whose Mb exceeds the decision kernel's plane budget must
    fall back to the host coder, not silently truncate bitplanes
    (ADVICE r3: precision >= ~21 made max_planes clamp corrupt streams)."""
    from go_jpeg2000_tpu.models.encoder import encode_batch
    from go_jpeg2000_tpu.models.decoder import decode_batch
    from go_jpeg2000_tpu.options import Format, Options

    rng = np.random.RandomState(5)
    # int32 input is signed: keep magnitudes within precision-22 range
    img = rng.randint(-(1 << 20), 1 << 20, size=(64, 64)).astype(np.int32)
    opts = Options(format=Format.J2K, lossless=True, num_resolutions=2,
                   high_throughput=False, backend="device", precision=22)
    streams = encode_batch([img], opts)
    dec = decode_batch(streams)
    assert np.array_equal(dec[0], img)


def test_native_mq_streams_matches_oracle():
    """native mq_encode_streams (the host half of the hybrid
    device-decisions + host-MQ ablation) must be byte-identical to
    MQEncoder AND to the device lockstep kernel on the same streams."""
    from go_jpeg2000_tpu.native import loader
    if not loader.available():
        pytest.skip("native unavailable")
    rng = np.random.RandomState(17)
    streams = []
    packed = []
    for n in (0, 1, 33, 200, 501):
        s = [(int(rng.randint(0, 19)), int(rng.randint(0, 2)))
             for _ in range(n)]
        streams.append(s)
        packed.append(bytes(cx | (bit << 5) for cx, bit in s))
    segs = loader.mq_encode_streams(packed)
    for s, seg in zip(streams, segs):
        assert seg == _oracle_segment(s) if s else seg == b""
