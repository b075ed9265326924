"""Tests for MCT, colorspace, and quantization ops.

Reference test parity: internal/mct/mct_test.go (RCT exact, ICT tolerance,
CustomMCT NxN inverse), colorspace_spec_test.go (spec-vector checks).
"""
import numpy as np
import pytest

from go_jpeg2000_tpu.codestream.header import StepSize
from go_jpeg2000_tpu.ops import colorspace as cs_ops
from go_jpeg2000_tpu.ops import mct, quant
from go_jpeg2000_tpu.options import ColorSpace
from go_jpeg2000_tpu.utils import markers as mk


class TestRCT:
    def test_roundtrip_exact(self):
        rng = np.random.RandomState(0)
        r = rng.randint(-(2 ** 15), 2 ** 15, size=(64, 64)).astype(np.int32)
        g = rng.randint(-(2 ** 15), 2 ** 15, size=(64, 64)).astype(np.int32)
        b = rng.randint(-(2 ** 15), 2 ** 15, size=(64, 64)).astype(np.int32)
        y, u, v = mct.forward_rct(r, g, b)
        r2, g2, b2 = mct.inverse_rct(y, u, v)
        np.testing.assert_array_equal(np.asarray(r2), r)
        np.testing.assert_array_equal(np.asarray(g2), g)
        np.testing.assert_array_equal(np.asarray(b2), b)

    def test_known_values(self):
        y, u, v = mct.forward_rct(np.array([100]), np.array([50]), np.array([25]))
        # Y = floor((100 + 100 + 25)/4) = 56, U = 25-50 = -25, V = 100-50 = 50
        assert int(np.asarray(y)[0]) == 56
        assert int(np.asarray(u)[0]) == -25
        assert int(np.asarray(v)[0]) == 50

    def test_negative_floor_semantics(self):
        # floor division of negative sums must match arithmetic shift
        y, u, v = mct.forward_rct(np.array([-3]), np.array([-1]), np.array([-2]))
        # R+2G+B = -7; floor(-7/4) = -2
        assert int(np.asarray(y)[0]) == -2


class TestICT:
    def test_roundtrip_tolerance(self):
        rng = np.random.RandomState(1)
        r = rng.uniform(-128, 127, size=(32, 32)).astype(np.float32)
        g = rng.uniform(-128, 127, size=(32, 32)).astype(np.float32)
        b = rng.uniform(-128, 127, size=(32, 32)).astype(np.float32)
        y, cb, cr = mct.forward_ict(r, g, b)
        r2, g2, b2 = mct.inverse_ict(y, cb, cr)
        np.testing.assert_allclose(np.asarray(r2), r, atol=1e-2)
        np.testing.assert_allclose(np.asarray(g2), g, atol=1e-2)
        np.testing.assert_allclose(np.asarray(b2), b, atol=1e-2)

    def test_bt601_luma(self):
        y, _, _ = mct.forward_ict(np.array([255.0]), np.array([0.0]), np.array([0.0]))
        np.testing.assert_allclose(np.asarray(y)[0], 0.299 * 255, rtol=1e-5)


class TestDCShift:
    @pytest.mark.parametrize("precision", [1, 8, 12, 16])
    def test_roundtrip(self, precision):
        rng = np.random.RandomState(precision)
        x = rng.randint(0, 2 ** precision, size=(16, 16)).astype(np.int32)
        s = mct.dc_shift_forward(x, precision, signed=False)
        assert abs(int(np.asarray(s).max())) <= 2 ** (precision - 1)
        x2 = mct.dc_shift_inverse(s, precision, signed=False)
        np.testing.assert_array_equal(np.asarray(x2), x)

    def test_signed_noop(self):
        x = np.array([-5, 5], dtype=np.int32)
        np.testing.assert_array_equal(
            np.asarray(mct.dc_shift_forward(x, 8, signed=True)), x)

    def test_clamp(self):
        x = np.array([-10, 300], dtype=np.int32)
        np.testing.assert_array_equal(
            np.asarray(mct.clamp_to_precision(x, 8, signed=False)), [0, 255])
        np.testing.assert_array_equal(
            np.asarray(mct.clamp_to_precision(x, 8, signed=True)), [-10, 127])


class TestCustomMCT:
    @pytest.mark.parametrize("n", [2, 3, 4, 5])
    def test_roundtrip(self, n):
        rng = np.random.RandomState(n)
        m = rng.uniform(-1, 1, size=(n, n)) + np.eye(n) * 2
        t = mct.CustomMCT(m)
        comps = rng.uniform(-100, 100, size=(n, 8, 8)).astype(np.float32)
        out = t.forward(comps)
        back = t.backward(out)
        np.testing.assert_allclose(np.asarray(back), comps, rtol=1e-3, atol=1e-2)

    def test_singular_rejected(self):
        with pytest.raises(ValueError):
            mct.CustomMCT(np.zeros((3, 3)))

    def test_non_square_rejected(self):
        with pytest.raises(ValueError):
            mct.CustomMCT(np.zeros((2, 3)))


class TestQuant:
    def test_quantize_deadzone(self):
        c = np.array([-7.9, -1.0, -0.5, 0.0, 0.5, 1.0, 7.9], dtype=np.float32)
        q = np.asarray(quant.quantize(c, delta=1.0))
        np.testing.assert_array_equal(q, [-7, -1, 0, 0, 0, 1, 7])

    def test_dequantize_midpoint(self):
        q = np.array([-3, 0, 3], dtype=np.int32)
        d = np.asarray(quant.dequantize(q, delta=2.0))
        np.testing.assert_allclose(d, [-7.0, 0.0, 7.0])

    def test_quant_dequant_error_bound(self):
        rng = np.random.RandomState(3)
        c = rng.uniform(-100, 100, size=1000).astype(np.float32)
        for delta in [0.5, 1.0, 4.0]:
            q = quant.quantize(c, delta)
            d = np.asarray(quant.dequantize(q, delta))
            assert np.abs(d - c).max() <= delta

    def test_reversible_quant_layout(self):
        q = quant.make_reversible_quant(precision=8, num_decomps=5)
        assert q.style == mk.QUANT_NONE
        assert len(q.step_sizes) == 16
        assert q.step_sizes[0].exponent == 8          # LL
        assert q.step_sizes[1].exponent == 9          # HL
        assert q.step_sizes[3].exponent == 10         # HH
        assert quant.max_bitplanes(q, 0, "LL", 5) == 2 + 8 - 1

    def test_irreversible_quant_monotone(self):
        q = quant.make_irreversible_quant(precision=8, num_decomps=5, base_delta=0.5)
        assert q.style == mk.QUANT_SCALAR_EXPOUNDED
        assert len(q.step_sizes) == 16
        # Coarser levels get smaller deltas (larger synthesis gain).
        d_coarse = q.step_sizes[1].value(8)   # res 1 HL (nb = 5)
        d_fine = q.step_sizes[13].value(8)    # res 5 HL (nb = 1)
        assert d_coarse < d_fine

    def test_effective_step_derived(self):
        from go_jpeg2000_tpu.codestream.header import Quantization
        q = Quantization(style=mk.QUANT_SCALAR_DERIVED, guard_bits=2,
                         step_sizes=[StepSize(0, 10)])
        nl = 3
        d_ll = quant.effective_step(q, 0, "LL", nl, 8)
        d_r1 = quant.effective_step(q, 1, "HL", nl, 8)   # nb = 3
        d_r3 = quant.effective_step(q, 3, "HH", nl, 8)   # nb = 1
        assert d_ll == d_r1      # same exponent (nb = NL)
        assert d_r3 == d_ll * 4  # eps smaller by 2 => step 4x


class TestColorspace:
    def _mid(self, precision=8):
        half = 1 << (precision - 1)
        return np.full((4, 4), half, dtype=np.int32)

    def test_sycc_gray_point(self):
        # Y = v, Cb = Cr = half => R = G = B = v
        y = np.full((4, 4), 99, dtype=np.int32)
        out = cs_ops.convert_sycc([y, self._mid(), self._mid()], 8)
        for ch in out:
            np.testing.assert_array_equal(np.asarray(ch), 99)

    def test_cmy_inversion(self):
        c = np.zeros((2, 2), dtype=np.int32)
        out = cs_ops.convert_cmy([c, c, c], 8)
        for ch in out:
            np.testing.assert_array_equal(np.asarray(ch), 255)

    def test_cmyk_black(self):
        z = np.zeros((2, 2), dtype=np.int32)
        k = np.full((2, 2), 255, dtype=np.int32)
        out = cs_ops.convert_cmyk([z, z, z, k], 8)
        for ch in out:
            np.testing.assert_array_equal(np.asarray(ch), 0)

    def test_cielab_white(self):
        # L=100, a=b=0 => white
        L = np.full((2, 2), 255, dtype=np.int32)
        ab = np.full((2, 2), 128, dtype=np.int32)
        out = cs_ops.convert_cielab([L, ab, ab], 8)
        for ch in out:
            assert np.asarray(ch).min() >= 250

    def test_cielab_black(self):
        L = np.zeros((2, 2), dtype=np.int32)
        ab = np.full((2, 2), 128, dtype=np.int32)
        out = cs_ops.convert_cielab([L, ab, ab], 8)
        for ch in out:
            assert np.asarray(ch).max() <= 5

    def test_ycbcr601_studio_range(self):
        # Y=16 (studio black), Cb=Cr=128 => RGB 0
        y = np.full((2, 2), 16, dtype=np.int32)
        c = np.full((2, 2), 128, dtype=np.int32)
        out = cs_ops.convert_ycbcr601([y, c, c], 8)
        for ch in out:
            np.testing.assert_array_equal(np.asarray(ch), 0)
        # Y=235 (studio white) => RGB 255
        y = np.full((2, 2), 235, dtype=np.int32)
        out = cs_ops.convert_ycbcr601([y, c, c], 8)
        for ch in out:
            np.testing.assert_array_equal(np.asarray(ch), 255)

    def test_dispatch_table(self):
        assert cs_ops.get_color_conversion(ColorSpace.SRGB) is None
        assert cs_ops.get_color_conversion(ColorSpace.GRAY) is None
        for c in [ColorSpace.SYCC, ColorSpace.CMYK, ColorSpace.CIELAB,
                  ColorSpace.ROMM_RGB, ColorSpace.YPBPR60]:
            assert cs_ops.get_color_conversion(c) is not None

    @pytest.mark.parametrize("precision", [4, 8, 12, 16])
    def test_precision_generic(self, precision):
        half = 1 << (precision - 1)
        y = np.full((2, 2), half // 2, dtype=np.int32)
        c = np.full((2, 2), half, dtype=np.int32)
        out = cs_ops.convert_sycc([y, c, c], precision)
        for ch in out:
            assert 0 <= np.asarray(ch).min() and np.asarray(ch).max() < (1 << precision)

    def test_srgb_gamma_roundtrip(self):
        v = np.linspace(0, 1, 64, dtype=np.float32)
        g = cs_ops.srgb_gamma(v)
        back = np.asarray(cs_ops.srgb_degamma(g))
        np.testing.assert_allclose(back, v, atol=1e-4)


class TestTransformWrappers:
    """models/transforms.py's batched forward and inverse programs against
    the plain lifting in ops/dwt.py, over (frames, height, width) shapes
    with odd-sized tails at deeper levels."""

    @staticmethod
    def _levels(h, w):
        return max(1, min(3, int(np.log2(min(h, w)))))

    @staticmethod
    def _frames(shape, seed):
        rng = np.random.RandomState(seed)
        return rng.randint(-2000, 2000, size=shape).astype(np.int32)

    @pytest.mark.parametrize("shape", [(1, 2, 2), (2, 64, 64), (1, 128, 256),
                                       (4, 32, 128), (3, 8, 8)])
    def test_forward_53_matches_dwt(self, shape):
        from go_jpeg2000_tpu.models import transforms
        from go_jpeg2000_tpu.ops import dwt
        n, h, w = shape
        x = self._frames(shape, shape[1])
        levels = self._levels(h, w)
        pyrs = transforms.run_forward_batch(x[:, None], levels, dwt.REV53,
                                            False, 12, True, 0, 0)
        ref = dwt.decompose(x, levels, dwt.REV53)
        for i in range(n):
            for lev, entry in enumerate(ref):
                for k, band in entry.items():
                    np.testing.assert_array_equal(pyrs[i][lev][k][0],
                                                  np.asarray(band)[i])

    @pytest.mark.parametrize("shape", [(1, 2, 2), (2, 64, 64), (1, 128, 256),
                                       (3, 8, 8)])
    def test_inverse_53_exact(self, shape):
        from go_jpeg2000_tpu.models import transforms
        from go_jpeg2000_tpu.ops import dwt
        n, h, w = shape
        x = self._frames(shape, shape[1] + 1)
        levels = self._levels(h, w)
        pyrs = transforms.run_forward_batch(x[:, None], levels, dwt.REV53,
                                            False, 12, True, 0, 0)
        rec = transforms.run_inverse_batch(pyrs, 1, levels, dwt.REV53,
                                           False, 12, True, 0, 0)
        np.testing.assert_array_equal(rec.reshape(n, h, w), x)
        ref = dwt.reconstruct(dwt.decompose(x, levels, dwt.REV53),
                              dwt.REV53)
        np.testing.assert_array_equal(rec.reshape(n, h, w), np.asarray(ref))

    @pytest.mark.parametrize("shape", [(2, 64, 64), (1, 128, 256), (3, 8, 8)])
    def test_97_matches_dwt(self, shape):
        from go_jpeg2000_tpu.models import transforms
        from go_jpeg2000_tpu.ops import dwt
        n, h, w = shape
        x = self._frames(shape, shape[1] + 2)
        levels = self._levels(h, w)
        pyrs = transforms.run_forward_batch(x[:, None], levels, dwt.IRR97,
                                            False, 12, True, 0, 0)
        ref = dwt.decompose(x.astype(np.float32), levels, dwt.IRR97)
        for i in range(n):
            for lev, entry in enumerate(ref):
                for k, band in entry.items():
                    np.testing.assert_allclose(pyrs[i][lev][k][0],
                                               np.asarray(band)[i],
                                               rtol=1e-4, atol=1e-3)
        rec = transforms.run_inverse_batch(pyrs, 1, levels, dwt.IRR97,
                                           False, 12, True, 0, 0)
        np.testing.assert_allclose(rec.reshape(n, h, w), x, atol=1)
