"""Sim(3) estimation between keyframes: batched RANSAC + GN refinement.

Reference counterparts: ``Sim3Solver`` (Horn closed form inside the
sequential RANSAC template, src/Sim3Solver.cc:24-259) and
``Optimizer::OptimizeSim3`` (g2o Sim3 vertex + fixed point pairs +
forward/backward projection edges, src/Optimizer.cc:464-619).

Design: all RANSAC hypotheses at once (vmapped Horn with scale), one
dense bidirectional-reprojection scoring pass; the refinement is batched
Gauss-Newton on the sim(3) tangent with Jacobians from ``jax.jacfwd``
(exact, no hand-derived 7-dof chain rule).  Stereo maps fix the scale
(``bFixScale`` — Sim3Solver.h:71-76) by zeroing the σ update component.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..geometry import sim3
from ..geometry.align import horn_align
from ..geometry.camera import CameraParams
from ..geometry.robust import huber_weight


def ransac_sim3(
    pc1: jnp.ndarray,       # [N, 3] matched points in camera frame 1
    pc2: jnp.ndarray,       # [N, 3] matched points in camera frame 2
    valid: jnp.ndarray,     # bool[N]
    cam: CameraParams,
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    key: jnp.ndarray,
    *,
    n_hyp: int = 64,
    min_set: int = 3,
    fix_scale: bool = True,
    chi2_th: float = 9.21,
) -> Tuple[sim3.Sim3, jnp.ndarray, jnp.ndarray]:
    """Estimate S12 (frame2 → frame1) with parallel hypotheses.

    Inliers are gated by *bidirectional* reprojection error < 9.21·σ²
    (Sim3Solver.cc:215-259).  Returns (S12, inliers, n_inliers).
    """
    N = pc1.shape[0]
    logits = jnp.where(valid, 0.0, -1e9)
    keys = jax.random.split(key, n_hyp)

    def sample(k):
        return jax.random.choice(k, N, shape=(min_set,), replace=False, p=jax.nn.softmax(logits))

    sets = jax.vmap(sample)(keys)
    # hypothesis: pc1 ≈ s R pc2 + t
    R, t, s = horn_align(pc2[sets], pc1[sets], jnp.ones(sets.shape), with_scale=not fix_scale)
    if fix_scale:
        s = jnp.ones_like(s)
    S12 = sim3.Sim3(R=R, t=t, s=s)

    def proj(p):
        z = jnp.where(p[..., 2] > 1e-6, p[..., 2], 1e-6)
        return jnp.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], -1)

    # forward: map pc2 into frame 1, compare against pc1's projection
    uv1_obs = proj(pc1)
    uv2_obs = proj(pc2)
    p2in1 = sim3.apply(sim3.Sim3(R=R[:, None], t=t[:, None], s=s[:, None]), pc2[None, :, :])
    e1 = jnp.sum((proj(p2in1) - uv1_obs[None]) ** 2, -1) * inv_sigma2_1[None]
    Sinv = sim3.inverse(S12)
    p1in2 = sim3.apply(sim3.Sim3(R=Sinv.R[:, None], t=Sinv.t[:, None], s=Sinv.s[:, None]), pc1[None, :, :])
    e2 = jnp.sum((proj(p1in2) - uv2_obs[None]) ** 2, -1) * inv_sigma2_2[None]
    inl = (e1 < chi2_th) & (e2 < chi2_th) & valid[None, :] & (p2in1[..., 2] > 0) & (p1in2[..., 2] > 0)
    scores = jnp.sum(inl.astype(jnp.int32), axis=1)
    best = jnp.argmax(scores)
    S_best = sim3.Sim3(R=R[best], t=t[best], s=s[best])
    return S_best, inl[best], scores[best]


def optimize_sim3(
    S12: sim3.Sim3,
    pc1: jnp.ndarray,
    pc2: jnp.ndarray,
    valid: jnp.ndarray,
    cam: CameraParams,
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    *,
    fix_scale: bool = True,
    iters: int = 10,
    chi2_th: float = 9.21,
    damping: float = 1e-6,
) -> Tuple[sim3.Sim3, jnp.ndarray, jnp.ndarray]:
    """GN refinement of S12 on fixed point pairs with bidirectional
    projection residuals and Huber δ=√9.21 (OptimizeSim3, Optimizer.cc:464-619).
    Returns (S12_opt, inliers, n_inliers)."""

    def proj(p):
        z = jnp.where(p[..., 2] > 1e-6, p[..., 2], 1e-6)
        return jnp.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], -1)

    uv1_obs = proj(pc1)
    uv2_obs = proj(pc2)

    def residuals(xi, S):
        """4-vector residual per point: forward + backward pixel errors."""
        Sd = sim3.compose(sim3.exp(xi), S)
        p2in1 = sim3.apply(Sd, pc2)
        Sinv = sim3.inverse(Sd)
        p1in2 = sim3.apply(Sinv, pc1)
        r_fwd = (proj(p2in1) - uv1_obs) * jnp.sqrt(inv_sigma2_1)[:, None]
        r_bwd = (proj(p1in2) - uv2_obs) * jnp.sqrt(inv_sigma2_2)[:, None]
        return jnp.concatenate([r_fwd, r_bwd], axis=-1)  # [N, 4]

    def chi2_of(S):
        r = residuals(jnp.zeros(7), S)
        return jnp.sum(r[:, :2] ** 2, -1), jnp.sum(r[:, 2:] ** 2, -1)

    def step(_, S):
        r0 = residuals(jnp.zeros(7), S)
        J = jax.jacfwd(residuals)(jnp.zeros(7), S)  # [N, 4, 7]
        c1, c2 = chi2_of(S)
        w = valid.astype(jnp.float32) * jnp.minimum(
            huber_weight(c1, chi2_th), huber_weight(c2, chi2_th)
        )
        H = jnp.einsum("nki,n,nkj->ij", J, w, J)
        b = jnp.einsum("nki,n,nk->i", J, w, r0)
        if fix_scale:
            # pin the scale DOF (stereo maps: bFixScale, Sim3Solver.h:71-76)
            H = H.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
            b = b.at[6].set(0.0)
        H = H + damping * jnp.eye(7)
        dx = -jnp.linalg.solve(H, b)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros(7))
        return sim3.compose(sim3.exp(dx), S)

    S_opt = jax.lax.fori_loop(0, iters, step, S12)
    c1, c2 = chi2_of(S_opt)
    inl = valid & (c1 < chi2_th) & (c2 < chi2_th)
    return S_opt, inl, jnp.sum(inl.astype(jnp.int32))
