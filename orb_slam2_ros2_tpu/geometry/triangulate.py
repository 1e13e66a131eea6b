"""Batched two-view triangulation.

The reference triangulates one candidate pair at a time with an OpenCV SVD on
the 4×4 DLT system, gated by the singular-value ratio σ₃/σ₂ > 1e-3
(reference: src/LocalMapping.cc:311-339 ``triangulate``).  Here the DLT is
built for *all* candidate matches at once and solved with a vmapped SVD —
one XLA batched kernel instead of a per-point loop.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import se3
from .camera import CameraParams


def dlt_rows(cam: CameraParams, Tcw: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Two DLT rows for one view: [..., 2, 4].

    Rows are ``x·P3 - P1`` and ``y·P3 - P2`` with P = K[R|t] and (x, y) the
    *normalized* coords, matching the reference's construction
    (LocalMapping.cc:316-325 uses unprojected unit-depth points).
    """
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    P = Tcw[..., :3, :]  # [R|t], 3×4
    r0 = x[..., None] * P[..., 2, :] - P[..., 0, :]
    r1 = y[..., None] * P[..., 2, :] - P[..., 1, :]
    return jnp.stack([r0, r1], axis=-2)


def _sym3_eigenvalues(M: jnp.ndarray):
    """Closed-form (Cardano) eigenvalues of symmetric [..., 3, 3] matrices,
    returned ascending.  Branch-free, ~30 elementwise ops — batched 3×3/4×4
    decompositions via jnp.linalg lower to iterative solvers."""
    q = jnp.trace(M, axis1=-2, axis2=-1) / 3.0
    Mq = M - q[..., None, None] * jnp.eye(3, dtype=M.dtype)
    p2 = jnp.sum(Mq * Mq, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(Mq / p[..., None, None])
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    l1 = q + 2.0 * p * jnp.cos(phi)                       # largest
    l3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    l2 = 3.0 * q - l1 - l3
    return l3, l2, l1


def triangulate_pairs(
    cam: CameraParams,
    Tcw1: jnp.ndarray,  # [..., 4, 4] world→cam1
    uv1: jnp.ndarray,   # [..., 2]
    Tcw2: jnp.ndarray,
    uv2: jnp.ndarray,
    rank_gate: float = 1e-3,
):
    """DLT-triangulate matched observations.

    Returns (points_w [..., 3], ok [...]).  Formulation: instead of the
    reference's 4×4 SVD null vector (LocalMapping.cc:329-331 — batched small
    SVDs lower to an iterative solver), solve the
    inhomogeneous system ``A[:, :3] X = −A[:, 3]`` via 3×3 normal equations
    with a closed-form adjugate inverse.  The two formulations minimize the
    same algebraic error; homogeneous solutions with w≈0 (points at
    infinity) appear here as ill-conditioned normal equations and are
    rejected by the same rank gate: the reference's σ₄/σ₃ ≤ ``rank_gate``
    (clean 1-D null space) maps to λ_min/λ_max of AᵀA restricted to the
    solution space — gated via the closed-form (Cardano) eigenvalues of M.
    """
    A = jnp.concatenate([dlt_rows(cam, Tcw1, uv1), dlt_rows(cam, Tcw2, uv2)], axis=-2)
    A3 = A[..., :3]                      # [..., 4, 3]
    b = -A[..., 3]                       # [..., 4]
    M = jnp.einsum("...ki,...kj->...ij", A3, A3)          # [..., 3, 3] PSD
    rhs = jnp.einsum("...ki,...k->...i", A3, b)           # [..., 3]

    # adjugate inverse of the symmetric 3×3
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    adj = jnp.stack([
        jnp.stack([c00, c01, c02], axis=-1),
        jnp.stack([c01, c11, c12], axis=-1),
        jnp.stack([c02, c12, c22], axis=-1),
    ], axis=-2)
    ok_det = jnp.abs(det) > 1e-20
    pw = jnp.einsum("...ij,...j->...i", adj, rhs) / jnp.where(ok_det, det, 1.0)[..., None]

    l_min, _, l_max = _sym3_eigenvalues(M)
    # conditioning gate: degenerate geometry (zero baseline, parallel rays)
    # collapses λ_min of the normal equations — the counterpart of the
    # reference's dirty-null-space rejection.  rank_gate enters squared
    # because M = AᵀA squares singular values.
    ok_rank = l_min > (rank_gate * rank_gate) * jnp.maximum(l_max, 1e-20)
    return pw, ok_rank & ok_det


def parallax_cos(
    Tcw1: jnp.ndarray, uv1_norm: jnp.ndarray, Tcw2: jnp.ndarray, uv2_norm: jnp.ndarray
) -> jnp.ndarray:
    """Cosine of the ray parallax angle between two views for normalized image
    coords [..., 2] (reference parallax choice, LocalMapping.cc:231-259).
    Rays are rotated into the world frame; smaller cos = larger parallax."""
    r1 = jnp.concatenate([uv1_norm, jnp.ones_like(uv1_norm[..., :1])], axis=-1)
    r2 = jnp.concatenate([uv2_norm, jnp.ones_like(uv2_norm[..., :1])], axis=-1)
    Rwc1 = jnp.swapaxes(se3.R_of(Tcw1), -1, -2)
    Rwc2 = jnp.swapaxes(se3.R_of(Tcw2), -1, -2)
    d1 = jnp.einsum("...ij,...j->...i", Rwc1, r1)
    d2 = jnp.einsum("...ij,...j->...i", Rwc2, r2)
    num = jnp.sum(d1 * d2, axis=-1)
    den = jnp.linalg.norm(d1, axis=-1) * jnp.linalg.norm(d2, axis=-1)
    return num / jnp.maximum(den, 1e-12)


def depth_in_view(Tcw: jnp.ndarray, pw: jnp.ndarray) -> jnp.ndarray:
    """z-coordinate of world points in a camera (positive-depth checks,
    LocalMapping.cc:265-271)."""
    return se3.apply(Tcw, pw)[..., 2]
