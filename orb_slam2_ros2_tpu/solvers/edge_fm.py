"""Feature-major ("planar") bundle-adjustment edge terms.

Layout chosen for accelerators that tile an array's trailing two dims (to
(8, 128) on the first target): the obvious BA edge layout — ``[P, O, 3, 6]``
Jacobian tensors — then pads each tiny trailing ``3×6`` block, inflating
device memory and traffic up to ~28×; at the full map capacity (2.6e5
points × 24 obs) one such tensor would take 25 GB.  This module instead keeps
every per-edge quantity as a stack of SCALAR planes with the component axis
LEADING and the (many-edges) axes trailing::

    r   [3,  *E]      residual components (u, v, u_right)
    Jc  [18, *E]      camera Jacobian, row-major (residual k, se3 param j) → 6k+j
    Jp  [9,  *E]      point Jacobian, (k, j) → 3k+j

where ``*E`` is any edge-grid shape whose minor dim is large (e.g. ``[O, M]``
obs-slot-major or ``[N, K]`` feature-slot-major) — zero layout padding, and
every contraction over the tiny component axes unrolls to fused vector ops.

The math mirrors the reference's g2o stereo/mono reprojection edges
(src/Optimizer.cc:86-160): residual (u−u̅, v−v̅, uʳ−u̅ʳ), analytic Jacobians
of the pinhole + SE3 action, third row masked for mono edges.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..geometry.camera import CameraParams


class EdgeTerms(NamedTuple):
    r: jnp.ndarray     # f32[3, *E]
    Jc: jnp.ndarray    # f32[18, *E]  (6k+j)
    Jp: jnp.ndarray    # f32[9, *E]   (3k+j)
    dim: jnp.ndarray   # f32[3, *E]   residual-dimension mask (1, 1, is_stereo)
    chi2: jnp.ndarray  # f32[*E]      Σ_k r_k² · dim_k · inv_sigma2


def edge_terms(
    cam: CameraParams,
    R9: jnp.ndarray,        # f32[9, *E] per-edge camera rotation (row-major)
    t3: jnp.ndarray,        # f32[3, *E] per-edge camera translation
    pw3: jnp.ndarray,       # f32[3, *E] per-edge world point
    uv2: jnp.ndarray,       # f32[2, *E] measured pixel
    right_u: jnp.ndarray,   # f32[*E]    measured right-image u (−1 = mono)
    inv_sigma2: jnp.ndarray,  # f32[*E]
) -> EdgeTerms:
    """Residuals + analytic Jacobians for a batch of reprojection edges."""
    px, py, pz = pw3[0], pw3[1], pw3[2]
    x = R9[0] * px + R9[1] * py + R9[2] * pz + t3[0]
    y = R9[3] * px + R9[4] * py + R9[5] * pz + t3[1]
    z = R9[6] * px + R9[7] * py + R9[8] * pz + t3[2]
    z = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    is_stereo = right_u > 0

    r0 = u - uv2[0]
    r1 = v - uv2[1]
    r2 = jnp.where(is_stereo, ur - right_u, 0.0)
    one = jnp.ones_like(r0)
    st = is_stereo.astype(r0.dtype)
    dim = jnp.stack([one, one, st])

    # ∂pix/∂pc rows (du, dv, dur), each a 3-vector of planes
    zero = jnp.zeros_like(z)
    du = (cam.fx * inv_z, zero, -cam.fx * x * inv_z2)
    dv = (zero, cam.fy * inv_z, -cam.fy * y * inv_z2)
    dur = (du[0], du[1], du[2] + cam.bf * inv_z2)
    dpix = (du, dv, dur)

    # Jc[k, 0:3] = dpix[k];  Jc[k, 3:6] = dpix[k] · (−hat(pc))
    # −hat(pc) columns: col3 = (0, −z, y), col4 = (z, 0, −x), col5 = (−y, x, 0)
    Jc_rows = []
    for k in range(3):
        a0, a1, a2 = dpix[k]
        Jc_rows += [
            a0, a1, a2,
            a1 * (-z) + a2 * y,
            a0 * z + a2 * (-x),
            a0 * (-y) + a1 * x,
        ]
    Jc = jnp.stack(Jc_rows)

    # Jp[k, j] = Σ_a dpix[k][a] · R[a, j]   (∂pc/∂pw = R)
    Jp_rows = []
    for k in range(3):
        a0, a1, a2 = dpix[k]
        for j in range(3):
            Jp_rows.append(a0 * R9[j] + a1 * R9[3 + j] + a2 * R9[6 + j])
    Jp = jnp.stack(Jp_rows)

    r = jnp.stack([r0, r1, r2])
    chi2 = (r0 * r0 + r1 * r1 + r2 * r2 * st) * inv_sigma2
    return EdgeTerms(r=r, Jc=Jc, Jp=Jp, dim=dim, chi2=chi2)


def edge_chi2(
    cam: CameraParams,
    R9: jnp.ndarray, t3: jnp.ndarray, pw3: jnp.ndarray,
    uv2: jnp.ndarray, right_u: jnp.ndarray, inv_sigma2: jnp.ndarray,
) -> jnp.ndarray:
    """χ² only (no Jacobians) — cheap gate/cost evaluation."""
    px, py, pz = pw3[0], pw3[1], pw3[2]
    x = R9[0] * px + R9[1] * py + R9[2] * pz + t3[0]
    y = R9[3] * px + R9[4] * py + R9[5] * pz + t3[1]
    z = R9[6] * px + R9[7] * py + R9[8] * pz + t3[2]
    z = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    is_stereo = right_u > 0
    r0 = u - uv2[0]
    r1 = v - uv2[1]
    r2 = jnp.where(is_stereo, ur - right_u, 0.0)
    return (r0 * r0 + r1 * r1 + r2 * r2) * inv_sigma2


# symmetric-matrix component index maps
SYM3 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
SYM3_AT = {  # (a, b) → component index
    (0, 0): 0, (0, 1): 1, (1, 0): 1, (0, 2): 2, (2, 0): 2,
    (1, 1): 3, (1, 2): 4, (2, 1): 4, (2, 2): 5,
}
def hpp_comps(terms: EdgeTerms, w: jnp.ndarray, reduce_axis: int) -> jnp.ndarray:
    """Σ_edges Jpᵀ W Jp as 6 symmetric components [6, ...]."""
    wm = [w * terms.dim[k] for k in range(3)]
    outs = []
    for a, b in SYM3:
        s = 0.0
        for k in range(3):
            s = s + wm[k] * terms.Jp[3 * k + a] * terms.Jp[3 * k + b]
        outs.append(jnp.sum(s, axis=reduce_axis))
    return jnp.stack(outs)


def bp_comps(terms: EdgeTerms, w: jnp.ndarray, reduce_axis: int) -> jnp.ndarray:
    """Σ_edges Jpᵀ W r as [3, ...]."""
    wm = [w * terms.dim[k] for k in range(3)]
    outs = []
    for a in range(3):
        s = 0.0
        for k in range(3):
            s = s + wm[k] * terms.Jp[3 * k + a] * terms.r[k]
        outs.append(jnp.sum(s, axis=reduce_axis))
    return jnp.stack(outs)


def hcc_comps(terms: EdgeTerms, w: jnp.ndarray, reduce_axis=None) -> jnp.ndarray:
    """Jcᵀ W Jc as 21 symmetric components [21, ...]; reduced over
    ``reduce_axis`` when given, else per-edge."""
    wm = [w * terms.dim[k] for k in range(3)]
    outs = []
    for a in range(6):
        for b in range(a, 6):
            s = 0.0
            for k in range(3):
                s = s + wm[k] * terms.Jc[6 * k + a] * terms.Jc[6 * k + b]
            outs.append(jnp.sum(s, axis=reduce_axis) if reduce_axis is not None else s)
    return jnp.stack(outs)


def bc_comps(terms: EdgeTerms, w: jnp.ndarray, reduce_axis=None) -> jnp.ndarray:
    """Jcᵀ W r as [6, ...]; reduced over ``reduce_axis`` when given."""
    wm = [w * terms.dim[k] for k in range(3)]
    outs = []
    for a in range(6):
        s = 0.0
        for k in range(3):
            s = s + wm[k] * terms.Jc[6 * k + a] * terms.r[k]
        outs.append(jnp.sum(s, axis=reduce_axis) if reduce_axis is not None else s)
    return jnp.stack(outs)


def g_comps(terms: EdgeTerms, w: jnp.ndarray) -> jnp.ndarray:
    """Per-edge camera-point coupling G = Jcᵀ W Jp as [18, *E] (6×3 blocks,
    component (a, b) → 3a+b).  NOT reduced — G is needed per edge."""
    wm = [w * terms.dim[k] for k in range(3)]
    outs = []
    for a in range(6):
        for b in range(3):
            s = 0.0
            for k in range(3):
                s = s + wm[k] * terms.Jc[6 * k + a] * terms.Jp[3 * k + b]
            outs.append(s)
    return jnp.stack(outs)


def sym3_inv(c: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Closed-form inverse of symmetric 3×3 given as components [6, ...]
    ((00, 01, 02, 11, 12, 22)); returns the same component layout."""
    a, b, cc, d, e, f = c[0], c[1], c[2], c[3], c[4], c[5]
    # | a b c |
    # | b d e |
    # | c e f |
    A = d * f - e * e
    B = cc * e - b * f
    C = b * e - cc * d
    D = a * f - cc * cc
    E = b * cc - a * e
    F = a * d - b * b
    det = a * A + b * B + cc * C
    det = jnp.where(jnp.abs(det) > eps, det, jnp.where(det >= 0, eps, -eps))
    inv_det = 1.0 / det
    return jnp.stack([A, B, C, D, E, F]) * inv_det


def sym3_apply(c: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Symmetric 3×3 (components [6, ...]) times vector [3, ...]."""
    return jnp.stack([
        c[0] * v[0] + c[1] * v[1] + c[2] * v[2],
        c[1] * v[0] + c[3] * v[1] + c[4] * v[2],
        c[2] * v[0] + c[4] * v[1] + c[5] * v[2],
    ])


def sym6_apply(c: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Symmetric 6×6 (21 components [21, ...], (a,b≥a) row-major) times
    vector [6, ...]."""
    idx = {}
    k = 0
    for a in range(6):
        for b in range(a, 6):
            idx[(a, b)] = k
            idx[(b, a)] = k
            k += 1
    outs = []
    for a in range(6):
        s = 0.0
        for b in range(6):
            s = s + c[idx[(a, b)]] * v[b]
        outs.append(s)
    return jnp.stack(outs)


def sym6_to_dense(c: jnp.ndarray) -> jnp.ndarray:
    """[21, K] symmetric components → [K, 6, 6] dense (for the 6×6 Cholesky
    preconditioner / Schur diagonal)."""
    k = 0
    rows = [[None] * 6 for _ in range(6)]
    for a in range(6):
        for b in range(a, 6):
            rows[a][b] = c[k]
            rows[b][a] = c[k]
            k += 1
    M = jnp.stack([jnp.stack(r) for r in rows])  # [6, 6, K]
    return jnp.moveaxis(M, -1, 0)


def gT_apply(G: jnp.ndarray, x6: jnp.ndarray) -> jnp.ndarray:
    """Per-edge Gᵀ x: G [18, *E] (6×3 blocks), x6 [6, *E] → [3, *E]."""
    outs = []
    for b in range(3):
        s = 0.0
        for a in range(6):
            s = s + G[3 * a + b] * x6[a]
        outs.append(s)
    return jnp.stack(outs)


def g_apply(G: jnp.ndarray, z3: jnp.ndarray) -> jnp.ndarray:
    """Per-edge G z: G [18, *E], z3 [3, *E] → [6, *E]."""
    outs = []
    for a in range(6):
        s = 0.0
        for b in range(3):
            s = s + G[3 * a + b] * z3[b]
        outs.append(s)
    return jnp.stack(outs)
