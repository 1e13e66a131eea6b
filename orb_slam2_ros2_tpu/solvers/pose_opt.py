"""Pose-only optimization: batched Gauss-Newton on SE(3), replacing g2o.

The reference's ``Optimizer::OptimizePoseOnly`` builds a g2o graph with one
SE3 vertex and unary mono (2-DoF) / stereo (3-DoF) reprojection edges, runs
4 rounds × 10 LM iterations with χ² gating between rounds (outlier edges are
deactivated but can return), Huber kernels dropped in round 3, and a final
projection-bounds post-filter (reference: src/Optimizer.cc:33-203; χ²
thresholds 5.991/7.815, information = 1/σ² per octave).

Design: residuals and analytic Jacobians for ALL matches at once; the
normal equations are a 6×6 system assembled by one batched einsum — the whole
optimizer is a fixed-trip-count ``lax.fori_loop`` inside jit, no dynamic
control flow.  Outlier gating = a weight mask recomputed between rounds.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.camera import CameraParams
from ..geometry.robust import huber_weight


class PoseObs(NamedTuple):
    """Padded observation set for one frame's pose optimization.

    ``is_stereo`` selects the 3-DoF residual (u, v, uR); mono rows ignore the
    third component.  ``valid`` masks padding and unmatched slots.
    """

    pw: jnp.ndarray        # f32[M, 3] world points
    uv: jnp.ndarray        # f32[M, 2] observed keypoint
    right_u: jnp.ndarray   # f32[M] observed right-image u (stereo only)
    inv_sigma2: jnp.ndarray  # f32[M] octave information weight
    is_stereo: jnp.ndarray   # bool[M]
    valid: jnp.ndarray       # bool[M]


def residuals_and_jac(cam: CameraParams, Tcw: jnp.ndarray, obs: PoseObs):
    """Residuals r [M, 3] and Jacobians J = ∂r/∂ξ [M, 3, 6] for the update
    T ← exp(ξ)·T (left-multiplied twist, matching g2o's SE3 convention)."""
    pc = se3.apply(Tcw, obs.pw)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z

    r = jnp.stack(
        [u - obs.uv[..., 0], v - obs.uv[..., 1], jnp.where(obs.is_stereo, ur - obs.right_u, 0.0)],
        axis=-1,
    )

    # ∂(u,v,ur)/∂pc
    du = jnp.stack([cam.fx * inv_z, jnp.zeros_like(z), -cam.fx * x * inv_z2], axis=-1)
    dv = jnp.stack([jnp.zeros_like(z), cam.fy * inv_z, -cam.fy * y * inv_z2], axis=-1)
    dur = du + jnp.stack([jnp.zeros_like(z), jnp.zeros_like(z), cam.bf * inv_z2], axis=-1)
    dpix = jnp.stack([du, dv, dur], axis=-2)  # [M, 3, 3]

    # ∂pc/∂ξ for left update: [I | −pc^]
    I = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (*pc.shape[:-1], 3, 3))
    dpc = jnp.concatenate([I, -se3.hat(pc)], axis=-1)  # [M, 3, 6]
    J = dpix @ dpc  # [M, 3, 6]
    return r, J


def _residual_dim_mask(obs: PoseObs) -> jnp.ndarray:
    """[M, 3] mask: rows use 2 (mono) or 3 (stereo) residual components."""
    third = obs.is_stereo
    return jnp.stack([jnp.ones_like(third), jnp.ones_like(third), third], axis=-1).astype(jnp.float32)


def chi2_per_obs(cam: CameraParams, Tcw: jnp.ndarray, obs: PoseObs) -> jnp.ndarray:
    r, _ = residuals_and_jac(cam, Tcw, obs)
    dm = _residual_dim_mask(obs)
    return jnp.sum(r * r * dm, axis=-1) * obs.inv_sigma2


def optimize_pose(
    cam: CameraParams,
    Tcw0: jnp.ndarray,
    obs: PoseObs,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    rounds: int = 4,
    iters_per_round: int = 10,
    damping: float = 1e-4,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (Tcw_opt, inlier_mask [M], n_inliers).

    Round structure mirrors the reference: optimize, re-gate against the χ²
    threshold (outliers keep being re-tested each round so they can return,
    Optimizer.cc:143-171), drop the Huber kernel for the last two rounds
    (kernel removed at round 3 of 4, Optimizer.cc:156).
    """
    chi2_th = jnp.where(obs.is_stereo, chi2_stereo, chi2_mono)
    inlier = obs.valid

    # Truncation cut: beyond this the loss is CONSTANT (zero influence).
    # Huber alone is not redescending — one catastrophic mismatch (a point
    # projected at the z-clamp gives χ² ~1e17) out-weighs hundreds of good
    # observations through the linear tail and drags the pose off before the
    # χ² gates can react (observed).  Real mismatches from a bounded search
    # radius stay far below this cut.
    trunc = 1e4 * chi2_th

    from .linalg_small import cholesky_solve_spd

    dm = _residual_dim_mask(obs)

    Tcw = Tcw0
    for rnd in range(rounds):
        use_huber = rnd < rounds - 2

        def terms(T):
            """One combined pass: residuals + Jacobians → (cost, H, b)."""
            r, J = residuals_and_jac(cam, T, obs)
            chi2 = jnp.sum(r * r * dm, axis=-1) * obs.inv_sigma2
            w = obs.inv_sigma2 * inlier.astype(jnp.float32)
            w = jnp.where(chi2 < trunc, w, 0.0)  # redescending: monsters drop out
            if use_huber:
                w = w * huber_weight(chi2, chi2_th)
            wm = w[:, None] * dm  # [M, 3]
            H = jnp.einsum("mki,mk,mkj->ij", J, wm, J)
            b = jnp.einsum("mki,mk,mk->i", J, wm, r)
            if use_huber:
                c = jnp.where(
                    chi2 <= chi2_th, chi2,
                    2.0 * jnp.sqrt(chi2_th * jnp.maximum(chi2, 1e-12)) - chi2_th,
                )
                c_cap = 2.0 * jnp.sqrt(chi2_th * trunc) - chi2_th
            else:
                c, c_cap = chi2, trunc
            cost = jnp.sum(jnp.where(inlier, jnp.minimum(c, c_cap), 0.0))
            return cost, H, b

        def lm_step(_, carry):
            """Levenberg-Marquardt with step acceptance: a GN step that fails
            to reduce the robust cost is rejected and the damping raised —
            pure GN diverges on ill-conditioned (rotation-dominant) geometry
            even from centimetre-level initialization.

            ONE residual+Jacobian pass per iteration: the candidate pose's
            pass yields both its acceptance cost AND the next step's normal
            equations; on reject the carried H, b of the incumbent are reused
            with higher damping (pure-latency win — the per-iteration small
            ops dominate this solver's runtime).
            """
            T, lam, cost, H, b = carry
            Hd = H + lam * (jnp.eye(6, dtype=H.dtype) + jnp.diag(jnp.diag(H)))
            dx = -cholesky_solve_spd(Hd, b)
            dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, 0.0)
            T_new = se3.exp(dx) @ T
            cost_new, H_new, b_new = terms(T_new)
            accept = cost_new < cost
            T = jnp.where(accept, T_new, T)
            H = jnp.where(accept, H_new, H)
            b = jnp.where(accept, b_new, b)
            cost = jnp.where(accept, cost_new, cost)
            lam = jnp.where(accept, lam * 0.5, lam * 8.0)
            lam = jnp.clip(lam, 1e-7, 1e4)
            return T, lam, cost, H, b

        cost0, H0, b0 = terms(Tcw)
        carry = (Tcw, jnp.asarray(damping, jnp.float32), cost0, H0, b0)
        Tcw, _, _, _, _ = jax.lax.fori_loop(0, iters_per_round, lm_step, carry)
        chi2 = chi2_per_obs(cam, Tcw, obs)
        inlier = obs.valid & (chi2 < chi2_th)

    # Re-orthonormalize: ~40 f32 4×4 multiplies per call leave an O(1e-6)
    # rotation defect, and the tracker's velocity feedback (T_pred = V·T with
    # V = T·T_last⁻¹, inverse-by-transpose) DOUBLES any defect every frame —
    # without this projection the pose matrix degenerates geometrically.
    Tcw = se3.normalize(Tcw)
    n_inliers = jnp.sum(inlier.astype(jnp.int32))
    return Tcw, inlier, n_inliers
