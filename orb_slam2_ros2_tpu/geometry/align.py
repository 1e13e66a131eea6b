"""Closed-form point-set alignment (Horn quaternion method), batched.

The reference's Sim3 solver computes the Horn closed form via the 4×4 N
matrix and its maximal eigenvector (reference: src/Sim3Solver.cc:50-148),
with the *asymmetric* scale s = D/Sp and an optional fixed-scale mode for
stereo (Sim3Solver.h:71-76).  Here the same algebra is a batched jitted
function used by the Sim3-RANSAC, EPnP's control-point alignment, and
trajectory evaluation.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion [..., 4] (w, x, y, z) → rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def _max_eigvec_4x4(N: jnp.ndarray, squarings: int = 9) -> jnp.ndarray:
    """Maximal eigenvector of symmetric [..., 4, 4] matrices via shifted
    matrix squaring — ``jnp.linalg.eigh`` on batched 4×4s lowers to an
    iterative solver; squaring is a fixed chain of small matmuls.

    Shift by the Frobenius norm so B = N + cI is PSD with the same
    eigenvector order, then square B ``squarings`` times (normalizing to the
    largest entry for stability): B^(2⁹) amplifies the top eigenvalue by
    ratio^512, so even a 2% eigen-gap separates to f32 precision in nine
    4×4 matmuls.  The top eigenvector is then any dominant column; two seed
    applications + a Rayleigh pick guard a seed accidentally ⊥ to it.
    Exactly degenerate top pairs (λ₁=λ₂: rotation ambiguity from collinear
    point sets) return some vector of the top eigenspace — every consumer
    scores or refines the result (RANSAC consensus, GN)."""
    c = jnp.linalg.norm(N, axis=(-2, -1))                  # ‖N‖_F ≥ |λ_min|
    B = N + (c[..., None, None] + 1e-9) * jnp.eye(4, dtype=N.dtype)
    for _ in range(squarings):
        B = B @ B
        B = B / jnp.maximum(
            jnp.max(jnp.abs(B), axis=(-2, -1), keepdims=True), 1e-30
        )
    ones = jnp.ones(N.shape[:-1], N.dtype)
    alt = jnp.stack([ones[..., 0], -ones[..., 1], ones[..., 2], -ones[..., 3]], -1)
    v1 = jnp.einsum("...ij,...j->...i", B, ones)
    v2 = jnp.einsum("...ij,...j->...i", B, alt)
    n1 = jnp.linalg.norm(v1, axis=-1, keepdims=True)
    n2 = jnp.linalg.norm(v2, axis=-1, keepdims=True)
    v = jnp.where(n1 >= n2, v1, v2)
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


def horn_align(
    src: jnp.ndarray,      # [..., S, 3]
    dst: jnp.ndarray,      # [..., S, 3]
    weights: jnp.ndarray,  # [..., S] (0 masks a pair)
    with_scale: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Find (R, t, s) minimizing Σ w‖dst − (s·R·src + t)‖².

    Horn's quaternion method: R from the maximal eigenvector of the 4×4 N
    matrix built from the correlation M = Σ w·src̃·dst̃ᵀ; scale via the
    asymmetric D/Sp form the reference uses (Sim3Solver.cc:135-148).
    """
    wsum = jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), 1e-9)
    wn = weights / wsum
    mu_s = jnp.sum(src * wn[..., None], axis=-2, keepdims=True)
    mu_d = jnp.sum(dst * wn[..., None], axis=-2, keepdims=True)
    xs = (src - mu_s) * jnp.sqrt(wn)[..., None]
    xd = (dst - mu_d) * jnp.sqrt(wn)[..., None]
    M = jnp.einsum("...si,...sj->...ij", xs, xd)  # Σ w src̃ dst̃ᵀ

    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        axis=-2,
    )
    q = _max_eigvec_4x4(N)  # maximal eigenvector (w, x, y, z)
    R = quat_to_rot(q)

    if with_scale:
        # asymmetric scale: s = Σ dst̃·(R src̃) / Σ ‖src̃‖² (Sim3Solver.cc:135-148)
        rot_s = jnp.einsum("...ij,...sj->...si", R, xs)
        num = jnp.sum(xd * rot_s, axis=(-1, -2))
        den = jnp.maximum(jnp.sum(xs * xs, axis=(-1, -2)), 1e-12)
        s = num / den
    else:
        s = jnp.ones(M.shape[:-2], M.dtype)

    t = mu_d[..., 0, :] - s[..., None] * jnp.einsum("...ij,...j->...i", R, mu_s[..., 0, :])
    return R, t, s
