"""Multiple component transforms (ISO/IEC 15444-1 Annex G) on device.

Capability parity with the reference's mct package
(/root/reference/internal/mct/mct.go:14-345): exact integer RCT, float ICT
(BT.601), DC level shift, and custom NxN MCT matrices — expressed as
vectorized jnp element-wise ops that XLA fuses into surrounding kernels.

All functions take/return arrays of shape [..., H, W] per component triple
stacked on a leading axis, or a tuple of three arrays; integer RCT math is
exact in int32.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


# --- DC level shift (G.1.2) ------------------------------------------------

def dc_shift_forward(x: jnp.ndarray, precision: int, signed: bool) -> jnp.ndarray:
    """Subtract 2^(P-1) from unsigned samples (no-op for signed)."""
    if signed:
        return x
    return x - (1 << (precision - 1))


def dc_shift_inverse(x: jnp.ndarray, precision: int, signed: bool) -> jnp.ndarray:
    if signed:
        return x
    return x + (1 << (precision - 1))


def clamp_to_precision(x: jnp.ndarray, precision: int, signed: bool) -> jnp.ndarray:
    """Clamp reconstructed samples to the component's legal range."""
    if signed:
        lo, hi = -(1 << (precision - 1)), (1 << (precision - 1)) - 1
    else:
        lo, hi = 0, (1 << precision) - 1
    return jnp.clip(x, lo, hi)


# --- Reversible color transform (G.2) --------------------------------------

def forward_rct(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Y = floor((R + 2G + B)/4); U = B - G; V = R - G.  Exact in int32."""
    r = r.astype(jnp.int32)
    g = g.astype(jnp.int32)
    b = b.astype(jnp.int32)
    y = (r + 2 * g + b) >> 2           # arithmetic shift == floor division
    u = b - g
    v = r - g
    return y, u, v


def inverse_rct(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Exact inverse: G = Y - floor((U+V)/4); R = V + G; B = U + G."""
    y = y.astype(jnp.int32)
    u = u.astype(jnp.int32)
    v = v.astype(jnp.int32)
    g = y - ((u + v) >> 2)
    r = v + g
    b = u + g
    return r, g, b


# --- Irreversible color transform (G.3, BT.601 weights) --------------------

_ICT_FWD = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
], dtype=np.float32)

_ICT_INV = np.array([
    [1.0, 0.0, 1.402],
    [1.0, -0.344136, -0.714136],
    [1.0, 1.772, 0.0],
], dtype=np.float32)


def forward_ict(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    r = r.astype(jnp.float32)
    g = g.astype(jnp.float32)
    b = b.astype(jnp.float32)
    m = _ICT_FWD
    y = m[0, 0] * r + m[0, 1] * g + m[0, 2] * b
    cb = m[1, 0] * r + m[1, 1] * g + m[1, 2] * b
    cr = m[2, 0] * r + m[2, 1] * g + m[2, 2] * b
    return y, cb, cr


def inverse_ict(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    y = y.astype(jnp.float32)
    cb = cb.astype(jnp.float32)
    cr = cr.astype(jnp.float32)
    m = _ICT_INV
    r = y + m[0, 2] * cr
    g = y + m[1, 1] * cb + m[1, 2] * cr
    b = y + m[2, 1] * cb
    return r, g, b


# --- Custom NxN MCT (Part 2 style; reference parity mct.go:189-345) --------

class CustomMCT:
    """Arbitrary NxN decorrelation matrix applied across components.

    Forward multiplies the component vector by `matrix`; inverse uses the
    matrix inverse (computed once, host-side, via numpy.linalg.inv — the
    reference hand-rolls Gauss-Jordan; LAPACK is the idiomatic equivalent).
    """

    def __init__(self, matrix: np.ndarray):
        matrix = np.asarray(matrix, dtype=np.float64)
        if matrix.ndim != 2 or matrix.shape[0] != matrix.shape[1]:
            raise ValueError("MCT matrix must be square")
        if abs(np.linalg.det(matrix)) < 1e-12:
            raise ValueError("MCT matrix is singular")
        self.matrix = matrix
        self.inverse = np.linalg.inv(matrix)

    def forward(self, comps: jnp.ndarray) -> jnp.ndarray:
        """comps: [N, ...spatial] -> [N, ...spatial]."""
        m = jnp.asarray(self.matrix, dtype=jnp.float32)
        # HIGHEST: a GPU may otherwise contract float32 in TF32
        return jnp.einsum("ij,j...->i...", m, comps.astype(jnp.float32),
                          precision=jax.lax.Precision.HIGHEST)

    def backward(self, comps: jnp.ndarray) -> jnp.ndarray:
        m = jnp.asarray(self.inverse, dtype=jnp.float32)
        return jnp.einsum("ij,j...->i...", m, comps.astype(jnp.float32),
                          precision=jax.lax.Precision.HIGHEST)
