"""Tiny fixed-size linear algebra, unrolled.

Generic ``jnp.linalg.solve``/``svd`` on 3×3/6×6 matrices lower to iterative
LAPACK-style routines, each a chain of dependent small ops inside a
40-iteration optimizer loop.  These closed-form/unrolled versions are pure
elementwise/vector ops (a 6×6 SPD Cholesky is 21 multiply-adds of rows) and
batch over leading dimensions for free.
"""

from __future__ import annotations

import jax.numpy as jnp


def cholesky_solve_spd(A: jnp.ndarray, b: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Solve A x = b for SPD A [..., n, n] with b [..., n], n static & small.

    Unrolled Cholesky (no pivoting — valid for damped SPD normal matrices)
    followed by unrolled forward/backward substitution.  Everything is plain
    indexing, so XLA emits straight-line vector code.
    """
    n = A.shape[-1]
    # Cholesky: L lower-triangular with A = L Lᵀ
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, eps))
            else:
                L[i][j] = s / L[j][j]
    # forward: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # backward: Lᵀ x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def inv3(A: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Closed-form (adjugate) inverse of [..., 3, 3] matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) > eps, det, jnp.where(det >= 0, eps, -eps))
    inv = jnp.stack(
        [
            jnp.stack([A11, A12, A13], -1),
            jnp.stack([A21, A22, A23], -1),
            jnp.stack([A31, A32, A33], -1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


def rot_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] → quaternion [..., 4] (w, x, y, z), branch-free.

    Uses the four candidate extractions and selects the numerically best
    (largest pivot) via where-selects — no data-dependent control flow.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-12))

    # candidate 0: trace
    s0 = safe_sqrt(tr + 1.0) * 2
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    # candidate 1: m00 largest
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    # candidate 2: m11 largest
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    # candidate 3: m22 largest
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = jnp.where(use0, q0, jnp.where(use1, q1, jnp.where(use2, q2, q3)))
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )
