"""Batched EPnP + RANSAC for relocalization.

The reference runs EPnP inside a sequential adaptive RANSAC template
(reference: src/PnPSolver.cc — control points :139-176, barycentric :185-212,
M matrix :221-241, null vectors :249-272, ICP :89-131; Ransac.hpp:63-103).
Design: ALL hypotheses are generated and scored in parallel — sample H
minimal sets, vmap the EPnP closed form (12×12 eigendecomposition batch),
score every hypothesis against every correspondence on one [H, N] residual
grid, pick the argmax (SURVEY.md §2 #12-13: batched RANSAC replaces the
sequential loop).

The β-case search (N = 1, 2, 3 null-vector combinations, PnPSolver.cc:280-355)
and the Gauss-Newton β refinement (:367-395) run for every hypothesis — all
three cases are solved vectorized and the one with the lowest reprojection
error on the minimal set wins, mirroring the reference's case selection.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.align import horn_align
from ..geometry.camera import CameraParams


def epnp_solve(cam: CameraParams, pw: jnp.ndarray, uv: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form EPnP for one minimal set: pw [S, 3], uv [S, 2] → (Tcw, ok)."""
    S = pw.shape[0]
    # control points: centroid + PCA axes (PnPSolver.cc:139-176)
    c0 = jnp.mean(pw, axis=0)
    centered = pw - c0
    cov = centered.T @ centered / S
    eigval, eigvec = jnp.linalg.eigh(cov)
    # scale axes by sqrt eigenvalue (largest last).  An exactly planar set
    # has eigval[0] == 0; give that axis a small relative extent so the
    # barycentric system stays invertible — the β-case search (N=2/3)
    # handles the enlarged null space the flat geometry induces
    floor = 0.25 * jnp.maximum(eigval[2], 1e-9)
    axes = eigvec * jnp.sqrt(jnp.maximum(eigval, floor))[None, :]
    ctrl_w = jnp.concatenate([c0[None], c0[None] + axes.T], axis=0)  # [4, 3]

    # barycentric coordinates (PnPSolver.cc:185-212): pw = Σ α_i ctrl_i
    Cmat = jnp.concatenate([ctrl_w.T, jnp.ones((1, 4))], axis=0)  # [4, 4]
    pwh = jnp.concatenate([pw.T, jnp.ones((1, S))], axis=0)        # [4, S]
    alpha = jnp.linalg.solve(Cmat, pwh).T                          # [S, 4]

    # M matrix (PnPSolver.cc:221-241)
    u = uv[:, 0], uv[:, 1]
    fu, fv, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    a = alpha  # [S, 4]
    row_u = jnp.concatenate(
        [a * fu, jnp.zeros_like(a), a * (cx - uv[:, 0:1])], axis=1
    )  # [S, 12] ordered (x of 4 ctrls, y of 4, z of 4)
    row_v = jnp.concatenate(
        [jnp.zeros_like(a), a * fv, a * (cy - uv[:, 1:2])], axis=1
    )
    M = jnp.concatenate([row_u, row_v], axis=0)  # [2S, 12]
    # SVD of M itself, NOT eigh(MᵀM): squaring doubles the condition number
    # and in f32 the noise floor (~1e-6·σ_max²) swamps the true null
    # eigenvalue, returning a garbage direction as "smallest" (observed on
    # planar scenes).  Small-matrix SVD is acceptable here — relocalization
    # runs only from LOST (PnPSolver.cc:249-272 uses the same eigen-of-MtM in
    # f64, which we don't have).
    _, _, vt = jnp.linalg.svd(M, full_matrices=True)
    # four smallest-singular-value directions, each as 4 control points
    # [4, 3] in camera frame (layout x1..x4, y1..y4, z1..z4)
    Vk = jnp.stack(
        [
            jnp.stack([vt[11 - k, 0:4], vt[11 - k, 4:8], vt[11 - k, 8:12]], axis=1)
            for k in range(4)
        ]
    )  # [4(null), 4(ctrl), 3]

    # pairwise control-point difference vectors for the 6 pairs
    pi = jnp.asarray([0, 0, 0, 1, 1, 2])
    pj = jnp.asarray([1, 2, 3, 2, 3, 3])
    dv = Vk[:, pi] - Vk[:, pj]                          # [4, 6, 3]
    dw_vec = ctrl_w[pi] - ctrl_w[pj]                    # [6, 3]
    rho = jnp.sum(dw_vec * dw_vec, axis=1)              # [6] squared dists

    # β initializations for the three null-space cases (PnPSolver.cc:280-355)
    betas = _beta_cases(dv, rho)                        # [3, 4]
    # Gauss-Newton refinement of each case on the distance residuals
    # (PnPSolver.cc:367-395, 5 iterations)
    betas = jax.vmap(lambda b: _gauss_newton_betas(b, dv, rho))(betas)

    def pose_for(beta):
        ctrl_c = jnp.einsum("k,kij->ij", beta, Vk)      # [4, 3]
        pc = alpha @ ctrl_c
        sign = jnp.where(jnp.mean(pc[:, 2]) < 0, -1.0, 1.0)
        ctrl_c = ctrl_c * sign
        R, t, _ = horn_align(ctrl_w[None], ctrl_c[None], jnp.ones((1, 4)))
        Tcw = se3.from_Rt(R[0], t[0])
        # reprojection error of the minimal set picks the winning case
        pcs = se3.apply(Tcw, pw)
        z = jnp.maximum(pcs[:, 2], 1e-6)
        uh = fu * pcs[:, 0] / z + cx
        vh = fv * pcs[:, 1] / z + cy
        err = jnp.sum((uh - uv[:, 0]) ** 2 + (vh - uv[:, 1]) ** 2)
        err = jnp.where(jnp.all(jnp.isfinite(Tcw)), err, jnp.inf)
        return Tcw, err

    Tcws, errs = jax.vmap(pose_for)(betas)
    best = jnp.argmin(errs)
    Tcw = Tcws[best]
    # reject collinear/point-degenerate sets (eigval[1] ~ 0) but ACCEPT
    # planar ones (only eigval[0] = 0) — the β cases cover those
    ok = jnp.isfinite(errs[best]) & (eigval[1] > 1e-9 * jnp.maximum(eigval[2], 1e-12))
    return jnp.where(ok, Tcw, jnp.eye(4)), ok


def _beta_cases(dv: jnp.ndarray, rho: jnp.ndarray) -> jnp.ndarray:
    """β init for null-space dimensions N = 1, 2, 3 (the reference's case
    functions, PnPSolver.cc:280-355; the classic EPnP approximations solving
    the linearized inter-distance system).  Returns [3, 4] β rows."""
    d = jnp.einsum("kni,lni->kln", dv, dv)  # [4, 4, 6] pairwise dot products

    # case N=1: ρ = β₁² |dv1|² → β₁ = Σ|dv1||dw| / Σ|dv1|²
    b1 = jnp.sum(jnp.sqrt(d[0, 0] * rho)) / jnp.maximum(jnp.sum(d[0, 0]), 1e-12)
    case1 = jnp.asarray([1.0, 0.0, 0.0, 0.0]) * b1

    # case N=2: unknowns (β₁₁, β₁₂, β₂₂) over 6 equations
    L2 = jnp.stack([d[0, 0], 2.0 * d[0, 1], d[1, 1]], axis=1)  # [6, 3]
    b2v, *_ = jnp.linalg.lstsq(L2, rho)
    b2_0 = jnp.sqrt(jnp.abs(b2v[0]))
    b2_1 = jnp.sqrt(jnp.abs(b2v[2])) * jnp.where(
        jnp.sign(b2v[1]) * jnp.sign(b2v[0]) < 0, -1.0, 1.0
    )
    zero = jnp.zeros_like(b2_0)
    case2 = jnp.stack([b2_0, b2_1, zero, zero])

    # case N=3: unknowns (β₁₁, β₁₂, β₂₂, β₁₃, β₂₃) — B₃₃ dropped like the
    # classic approx_3
    L3 = jnp.stack(
        [d[0, 0], 2.0 * d[0, 1], d[1, 1], 2.0 * d[0, 2], 2.0 * d[1, 2]], axis=1
    )  # [6, 5]
    b3v, *_ = jnp.linalg.lstsq(L3, rho)
    b3_0 = jnp.sqrt(jnp.abs(b3v[0]))
    b3_1 = jnp.sqrt(jnp.abs(b3v[2])) * jnp.where(
        jnp.sign(b3v[1]) * jnp.sign(b3v[0]) < 0, -1.0, 1.0
    )
    b3_2 = b3v[3] / jnp.maximum(b3_0, 1e-12)
    case3 = jnp.stack([b3_0, b3_1, b3_2, zero])
    return jnp.stack([case1, case2, case3])


def _gauss_newton_betas(beta: jnp.ndarray, dv: jnp.ndarray, rho: jnp.ndarray, iters: int = 5) -> jnp.ndarray:
    """Refine β [4] so Σ_k (‖Σᵢ βᵢ dvᵢ‖² − ρ)² is minimized
    (PnPSolver::GaussNewton, :367-395): residuals over the 6 control-point
    pair distances, damped 4×4 normal-equation steps."""
    d = jnp.einsum("kni,lni->kln", dv, dv)  # [4, 4, 6]

    def step(b, _):
        # r_n = Σ_{k,l} b_k b_l d[k,l,n] − ρ_n ; ∂r/∂b_k = 2 Σ_l b_l d[k,l,n]
        r = jnp.einsum("k,l,kln->n", b, b, d) - rho        # [6]
        J = 2.0 * jnp.einsum("l,kln->nk", b, d)            # [6, 4]
        H = J.T @ J + 1e-9 * jnp.eye(4)
        g = J.T @ r
        db = jnp.linalg.solve(H, g)
        return b - db, None

    beta, _ = jax.lax.scan(step, beta, None, length=iters)
    return beta


def ransac_pnp(
    cam: CameraParams,
    pw: jnp.ndarray,        # [N, 3]
    uv: jnp.ndarray,        # [N, 2]
    inv_sigma2: jnp.ndarray,  # [N]
    valid: jnp.ndarray,     # bool[N]
    key: jnp.ndarray,
    *,
    n_hyp: int = 64,
    min_set: int = 6,
    chi2_th: float = 5.991,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Parallel-hypothesis EPnP RANSAC.  Returns (Tcw, inliers [N], n_inliers).

    Replaces PnPSolver::create + Ransac<T>::iterate (sequential, adaptive)
    with a fixed budget of vmapped hypotheses + one dense scoring pass.
    """
    N = pw.shape[0]
    # sample minimal sets weighted toward valid entries
    logits = jnp.where(valid, 0.0, -1e9)
    keys = jax.random.split(key, n_hyp)

    def sample(k):
        return jax.random.choice(k, N, shape=(min_set,), replace=False, p=jax.nn.softmax(logits))

    sets = jax.vmap(sample)(keys)  # [H, S]

    Tcws, oks = jax.vmap(lambda s: epnp_solve(cam, pw[s], uv[s]))(sets)

    # score all hypotheses × all correspondences
    pc = jnp.einsum("hij,nj->hni", se3.R_of(Tcws), pw) + se3.t_of(Tcws)[:, None, :]
    z = jnp.where(pc[..., 2] > 1e-6, pc[..., 2], 1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    err2 = ((u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2) * inv_sigma2[None, :]
    inl = (err2 < chi2_th) & (pc[..., 2] > 0) & valid[None, :]
    scores = jnp.sum(inl.astype(jnp.int32), axis=1) * oks.astype(jnp.int32)
    best = jnp.argmax(scores)
    return Tcws[best], inl[best], scores[best]
