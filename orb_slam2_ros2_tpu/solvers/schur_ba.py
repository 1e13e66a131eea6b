"""Bundle adjustment with Schur-complement reduction — the g2o replacement.

The reference's local/global BA builds g2o graphs: SE3 vertices, marginalized
landmark vertices, Huber-robust mono/stereo reprojection edges, LM iterations
with χ² gating (reference: src/Optimizer.cc:225-442 OptimizeLocalMap,
:934-1043 globalOptimization).  This module is the array-native equivalent:

**Data layout** — no sparse graph structure at all.  The edge set is the
dense grid ``[C cameras × N feature slots]`` with a validity mask: camera c's
feature slot n observes point-slot ``pt_slot[c, n]``.  Residuals, Jacobians
and weights are plain ``[C, N, ...]`` arrays.

**Reduced camera system as matmuls** — per-edge camera-point coupling blocks
``G = Jcᵀ W Jp [C, N, 6, 3]`` are segment-summed into the block matrix
``B [F·6, P·3]``; the Schur complement is two batched matmuls:

    S = Hcc − (B · blockdiag(Hpp+λ)⁻¹) · Bᵀ        (dense [F·6, F·6])
    b̃ = b_c − (B · blockdiag(Hpp+λ)⁻¹) · b_p

followed by one dense Cholesky solve and a matmul back-substitution for the
landmarks.  At F ≤ 32 free cameras (local BA) S is 192×192; the same engine
runs whole-map global BA (F = K) because S stays dense-Cholesky-friendly
up to thousands of cameras.

**Robustness** — Huber IRLS weights + χ² re-gating between iteration phases,
matching the reference's 5-iters → gate → 10-iters structure
(Optimizer.cc:321-349).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.camera import CameraParams
from ..geometry.robust import huber_weight


class BAProblem(NamedTuple):
    """Grid-layout BA problem.  C = #camera slots, N = features/cam, P = point slots."""

    cam_Tcw: jnp.ndarray     # f32[C, 4, 4]
    cam_free: jnp.ndarray    # bool[C] — optimized (False = fixed anchor)
    pt_pos: jnp.ndarray      # f32[P, 3]
    pt_valid: jnp.ndarray    # bool[P]
    # per-edge (camera-feature) observations
    pt_slot: jnp.ndarray     # i32[C, N] point slot (−1 = no edge)
    uv: jnp.ndarray          # f32[C, N, 2]
    right_u: jnp.ndarray     # f32[C, N] (−1 = mono)
    inv_sigma2: jnp.ndarray  # f32[C, N]
    edge_valid: jnp.ndarray  # bool[C, N]


def _edge_terms(cam: CameraParams, prob: BAProblem, Tcw: jnp.ndarray, pts: jnp.ndarray):
    """Residuals r [C,N,3], Jacobians Jc [C,N,3,6], Jp [C,N,3,3], dim mask."""
    P = pts.shape[0]
    slot = jnp.clip(prob.pt_slot, 0, P - 1)
    pw = pts[slot]                                       # [C, N, 3]
    pc = jnp.einsum("cij,cnj->cni", se3.R_of(Tcw), pw) + se3.t_of(Tcw)[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    is_stereo = prob.right_u > 0
    r = jnp.stack(
        [u - prob.uv[..., 0], v - prob.uv[..., 1], jnp.where(is_stereo, ur - prob.right_u, 0.0)],
        axis=-1,
    )
    zero = jnp.zeros_like(z)
    du = jnp.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], axis=-1)
    dv = jnp.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], axis=-1)
    dur = du + jnp.stack([zero, zero, cam.bf * inv_z2], axis=-1)
    dpix = jnp.stack([du, dv, dur], axis=-2)             # [C, N, 3, 3] ∂pix/∂pc
    I = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))
    dpc_dxi = jnp.concatenate([I, -se3.hat(pc)], axis=-1)  # [C, N, 3, 6]
    Jc = dpix @ dpc_dxi
    Jp = jnp.einsum("cnab,cbj->cnaj", dpix, se3.R_of(Tcw))  # ∂pc/∂pw = R
    dim = jnp.stack(
        [jnp.ones_like(is_stereo), jnp.ones_like(is_stereo), is_stereo], axis=-1
    ).astype(jnp.float32)
    return r, Jc, Jp, dim


def _solve_iteration(cam, prob, Tcw, pts, weights, lam):
    """One damped-GN Schur step.  weights [C, N] combines validity, Huber and
    information.  Returns (Tcw_new, pts_new)."""
    C, N = prob.pt_slot.shape
    P = pts.shape[0]
    F6 = C * 6

    r, Jc, Jp, dim = _edge_terms(cam, prob, Tcw, pts)
    wm = weights[..., None] * dim                        # [C, N, 3]

    # zero camera Jacobians of fixed cameras (their pose stays anchored)
    Jc = jnp.where(prob.cam_free[:, None, None, None], Jc, 0.0)

    # per-camera blocks
    Hcc = jnp.einsum("cnki,cnk,cnkj->cij", Jc, wm, Jc)   # [C, 6, 6]
    b_c = jnp.einsum("cnki,cnk,cnk->ci", Jc, wm, r)      # [C, 6]

    # --- per-point segment reductions as one-hot matmuls -------------------
    # onehotᵀ @ [G | Hpp | b_p] replaces a scatter-add (which the first
    # target lowered to a sort).  Everything stays f32: the normal-equation blocks span enough dynamic
    # range that bf16 operands make Wp = (Hpp+λ)⁻¹ garbage and the solver
    # diverges (verified) — the one-hot matmul is bandwidth-bound anyway.
    slot = jnp.where(prob.edge_valid, prob.pt_slot, P)
    G = jnp.einsum("cnki,cnk,cnkj->cnij", Jc, wm, Jp)    # [C, N, 6, 3]
    Hpp_e = jnp.einsum("cnki,cnk,cnkj->cnij", Jp, wm, Jp)  # [C, N, 3, 3]
    b_p_e = jnp.einsum("cnki,cnk,cnk->cni", Jp, wm, r)     # [C, N, 3]

    payload = jnp.concatenate(
        [G.reshape(C, N, 18), Hpp_e.reshape(C, N, 9), b_p_e], axis=-1
    )                                                     # [C, N, 30] f32

    def per_cam(slot_c, pay_c):
        onehot = (slot_c[:, None] == jnp.arange(P)[None, :]).astype(jnp.float32)
        return jnp.einsum(
            "np,nz->pz", onehot, pay_c, preferred_element_type=jnp.float32
        )                                                 # [P, 30]

    seg = jax.vmap(per_cam)(slot, payload)                # [C, P, 30]
    B = seg[..., :18].reshape(C, P, 6, 3)
    Hpp = jnp.sum(seg[..., 18:27], axis=0).reshape(P, 3, 3)
    b_p = jnp.sum(seg[..., 27:30], axis=0)                # [P, 3]

    # landmark marginalization
    from .linalg_small import inv3

    lamI3 = lam * jnp.eye(3)
    Wp = inv3(Hpp + lamI3[None] + 1e-9 * jnp.eye(3)[None])  # [P, 3, 3]
    Wp = jnp.where(prob.pt_valid[:, None, None], Wp, 0.0)

    BW = jnp.einsum("cpij,pjk->cpik", B, Wp)             # [C, P, 6, 3]
    # S[c1, c2] = Hcc δ − Σ_p BW[c1, p] @ B[c2, p]^T  → via one matmul
    BWf = jnp.transpose(BW, (0, 2, 1, 3)).reshape(C * 6, P * 3)
    Bf = jnp.transpose(B, (0, 2, 1, 3)).reshape(C * 6, P * 3)
    S = -BWf @ Bf.T                                      # [C6, C6]
    # add block-diagonal Hcc (+ LM damping + fixed-cam identity anchors)
    Hcc_d = Hcc + lam * jnp.eye(6)[None]
    anchor = jnp.where(prob.cam_free, 0.0, 1.0)[:, None, None] * jnp.eye(6)[None]
    idx = jnp.arange(C)
    S = S.reshape(C, 6, C, 6).at[idx, :, idx, :].add(Hcc_d + anchor).reshape(F6, F6)

    b_schur = b_c.reshape(-1) - (BWf @ b_p.reshape(-1))

    # dense solve (S is SPD by construction + damping)
    L, low = jax.scipy.linalg.cho_factor(S + 1e-8 * jnp.eye(F6))
    dx_c = -jax.scipy.linalg.cho_solve((L, low), b_schur)
    ok = jnp.all(jnp.isfinite(dx_c))
    dx_c = jnp.where(ok, dx_c, 0.0).reshape(C, 6)
    dx_c = jnp.where(prob.cam_free[:, None], dx_c, 0.0)

    # landmark back-substitution: dx_p = -Wp (b_p + Σ_c G^T dx_c)
    Gt_dx = jnp.einsum("cpij,ci->pj", B, dx_c.reshape(C, 6))
    dx_p = -jnp.einsum("pij,pj->pi", Wp, b_p + Gt_dx)
    dx_p = jnp.where(jnp.isfinite(dx_p), dx_p, 0.0)
    dx_p = jnp.where(prob.pt_valid[:, None], dx_p, 0.0)

    Tcw_new = se3.normalize(se3.exp(dx_c) @ Tcw)
    pts_new = pts + dx_p
    return Tcw_new, pts_new


def _chi2(cam, prob, Tcw, pts):
    r, _, _, dim = _edge_terms(cam, prob, Tcw, pts)
    return jnp.sum(r * r * dim, axis=-1) * prob.inv_sigma2


# --------------------------------------------------------------------------
# per-point layout: feature-major dense Schur (see solvers.edge_fm)
# --------------------------------------------------------------------------

class _PointFM(NamedTuple):
    """Obs-slot-major planes of a PointBAProblem: every array's minor dim is
    the (large) point axis, so nothing suffers trailing-dim tile padding."""

    ci: jnp.ndarray        # i32[O, P] clipped camera index
    uv: jnp.ndarray        # f32[2, O, P]
    right_u: jnp.ndarray   # f32[O, P]
    inv_sigma2: jnp.ndarray  # f32[O, P]
    valid: jnp.ndarray     # bool[O, P]


def _to_fm(prob) -> "_PointFM":
    C = prob.cam_Tcw.shape[0]
    return _PointFM(
        ci=jnp.clip(prob.obs_cam, 0, C - 1).T,
        uv=jnp.transpose(prob.obs_uv, (2, 1, 0)),
        right_u=prob.obs_right_u.T,
        inv_sigma2=prob.obs_inv_sigma2.T,
        valid=prob.obs_valid.T,
    )


def _fm_edge_terms(cam, fm: "_PointFM", Tcw, pts):
    """Feature-major edge terms for the per-point layout: gather per-edge
    camera rows (9+3 scalar-plane gathers — no [E, 3, 3] tensors), broadcast
    the per-point world position over the O axis."""
    from . import edge_fm

    C = Tcw.shape[0]
    Rf = Tcw[:, :3, :3].reshape(C, 9).T         # [9, C]
    tf = Tcw[:, :3, 3].T                        # [3, C]
    R9 = Rf[:, fm.ci]                           # [9, O, P]
    t3 = tf[:, fm.ci]
    pw3 = pts.T[:, None, :]                     # [3, 1, P] broadcasts over O
    return edge_fm.edge_terms(cam, R9, t3, pw3, fm.uv, fm.right_u, fm.inv_sigma2)


def _solve_iteration_points(cam, prob, fm, Tcw, pts, weights, lam):
    """One damped-GN dense-Schur step over the per-point layout in
    feature-major planes ([O, P]-shaped scalar arrays).

    The naive [P, O, 6, 3] block tensors can tile-pad their trailing dims
    to many times the logical bytes (solvers.edge_fm).  Here every per-edge
    quantity is a [k, O, P] stack of planes (zero padding), per-point
    reductions are sums over the O axis, and camera-space reductions ride one
    [≤27+18, O·P] × [O·P, C+1] one-hot matmul.  The Schur product stays
    one [C6, 3P] matmul:  S = blkdiag(Hcc+λ) − (B Wp) Bᵀ.

    ``weights`` is [O, P] (validity ⊗ Huber ⊗ information).
    """
    from . import edge_fm

    C = Tcw.shape[0]
    O, P = fm.ci.shape
    F6 = C * 6

    terms = _fm_edge_terms(cam, fm, Tcw, pts)
    # fixed cameras contribute no camera gradient
    free_g = prob.cam_free[fm.ci]                             # [O, P]
    terms = terms._replace(Jc=jnp.where(free_g[None], terms.Jc, 0.0))

    # per-point blocks: direct sums over the O axis
    Hpp6 = edge_fm.hpp_comps(terms, weights, reduce_axis=0)   # [6, P]
    b_p3 = edge_fm.bp_comps(terms, weights, reduce_axis=0)    # [3, P]
    lam_diag = jnp.zeros((6, 1)).at[jnp.asarray([0, 3, 5])].set(lam + 1e-9)
    Wp6 = edge_fm.sym3_inv(Hpp6 + lam_diag)
    Wp6 = jnp.where(prob.pt_valid[None, :], Wp6, 0.0)

    G = edge_fm.g_comps(terms, weights)                       # [18, O, P]

    # camera reductions: one-hot over C+1 (invalid edges → slot C)
    ci_oh = jnp.where(fm.valid, fm.ci, C)
    onehot = (ci_oh[None] == jnp.arange(C + 1)[:, None, None]).astype(jnp.float32)
    hcc_e = edge_fm.hcc_comps(terms, weights)                 # [21, O, P]
    bc_e = edge_fm.bc_comps(terms, weights)                   # [6, O, P]
    pay = jnp.concatenate([hcc_e, bc_e]).reshape(27, O * P)
    red = pay @ onehot.reshape(C + 1, O * P).T                # [27, C+1]
    Hcc21 = red[:21, :C]
    b_c = red[21:, :C]                                        # [6, C]

    # per-point per-camera coupling blocks B[c, p] = Σ_o onehot·G
    B18 = jnp.einsum("cop,gop->gcp", onehot, G)[:, :C]        # [18, C, P]
    # BW[c, p] = B[c, p] @ Wp[p]   (6×3 · sym3), componentwise planes
    S3 = edge_fm.SYM3_AT
    BW = jnp.stack([
        sum(B18[3 * a + j] * Wp6[S3[(j, b)]] for j in range(3))
        for a in range(6) for b in range(3)
    ])                                                        # [18, C, P]

    def flat(x18):  # [18, C, P] → [C6, 3P] with col index p·3+b
        return jnp.transpose(
            x18.reshape(6, 3, C, P), (2, 0, 3, 1)
        ).reshape(F6, P * 3)

    Uf = flat(BW)
    Vf = flat(B18)
    S = -(Uf @ Vf.T)
    Hcc = edge_fm.sym6_to_dense(Hcc21)                        # [C, 6, 6]
    Hcc_d = Hcc + lam * jnp.eye(6)[None]
    anchor = jnp.where(prob.cam_free, 0.0, 1.0)[:, None, None] * jnp.eye(6)[None]
    idx = jnp.arange(C)
    S = S.reshape(C, 6, C, 6).at[idx, :, idx, :].add(Hcc_d + anchor).reshape(F6, F6)

    b_schur = b_c.T.reshape(-1) - Uf @ b_p3.T.reshape(-1)

    L, low = jax.scipy.linalg.cho_factor(S + 1e-8 * jnp.eye(F6))
    dx_c = -jax.scipy.linalg.cho_solve((L, low), b_schur)
    ok = jnp.all(jnp.isfinite(dx_c))
    dx_c = jnp.where(ok, dx_c, 0.0).reshape(C, 6)
    dx_c = jnp.where(prob.cam_free[:, None], dx_c, 0.0)

    # landmark back-substitution: dx_p = −Wp (b_p + Σ_o Gᵀ dx_c)
    xg = dx_c.T[:, fm.ci]                                     # [6, O, P]
    tp = jnp.sum(edge_fm.gT_apply(G, xg), axis=1)             # [3, P]
    dx_p = edge_fm.sym3_apply(Wp6, b_p3 + tp)
    dx_p = jnp.where(jnp.isfinite(dx_p), dx_p, 0.0)
    dx_p = jnp.where(prob.pt_valid[None, :], dx_p, 0.0)

    Tcw_new = se3.normalize(se3.exp(dx_c) @ Tcw)
    pts_new = pts - dx_p.T
    return Tcw_new, pts_new


def solve_ba_points(
    cam: CameraParams,
    prob,  # pcg_ba.PointBAProblem
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    phase_iters: Tuple[int, int] = (3, 5),
    lam: float = 1e-3,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Two-phase robust dense-Schur BA over the per-point layout (the same
    5→gate→10 structure as ``solve_ba`` / Optimizer.cc:321-349, with LM step
    acceptance).  Returns (cam_Tcw, pt_pos, obs_inlier [P, O])."""
    fm = _to_fm(prob)
    chi2_th = jnp.where(fm.right_u > 0, chi2_stereo, chi2_mono)  # [O, P]
    Tcw, pts = prob.cam_Tcw, prob.pt_pos
    gate = fm.valid

    trunc = 1e4 * chi2_th
    rho_cap = 2.0 * jnp.sqrt(chi2_th * trunc) - chi2_th

    def chi2_of(Tcw_, pts_):
        return _fm_edge_terms(cam, fm, Tcw_, pts_).chi2          # [O, P]

    def robust_cost(Tcw_, pts_, gate_):
        chi2 = chi2_of(Tcw_, pts_)
        rho = jnp.where(
            chi2 <= chi2_th, chi2,
            2.0 * jnp.sqrt(chi2_th * jnp.maximum(chi2, 1e-12)) - chi2_th,
        )
        rho = jnp.minimum(rho, rho_cap)
        return jnp.sum(jnp.where(gate_, rho, 0.0))

    for n_iters in phase_iters:
        def body(_, carry):
            Tcw, pts, lam_c, cost = carry
            chi2 = chi2_of(Tcw, pts)
            w = gate.astype(jnp.float32) * fm.inv_sigma2 * huber_weight(chi2, chi2_th)
            w = jnp.where(chi2 < trunc, w, 0.0)
            Tcw_new, pts_new = _solve_iteration_points(cam, prob, fm, Tcw, pts, w, lam_c)
            cost_new = robust_cost(Tcw_new, pts_new, gate)
            accept = cost_new < cost
            Tcw = jnp.where(accept, Tcw_new, Tcw)
            pts = jnp.where(accept, pts_new, pts)
            cost = jnp.where(accept, cost_new, cost)
            lam_c = jnp.clip(jnp.where(accept, lam_c * 0.5, lam_c * 8.0), 1e-6, 1e3)
            return Tcw, pts, lam_c, cost

        carry = (Tcw, pts, jnp.asarray(lam, jnp.float32), robust_cost(Tcw, pts, gate))
        Tcw, pts, _, _ = jax.lax.fori_loop(0, n_iters, body, carry)
        chi2 = chi2_of(Tcw, pts)
        gate = fm.valid & (chi2 < chi2_th)

    return Tcw, pts, gate.T


def solve_ba(
    cam: CameraParams,
    prob: BAProblem,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    phase_iters: Tuple[int, int] = (5, 10),
    lam: float = 1e-3,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run the two-phase robust BA (5 iters → χ² gate → 10 iters, mirroring
    Optimizer.cc:321-349).  Returns (cam_Tcw, pt_pos, edge_inlier)."""
    chi2_th = jnp.where(prob.right_u > 0, chi2_stereo, chi2_mono)
    Tcw, pts = prob.cam_Tcw, prob.pt_pos
    gate = prob.edge_valid

    # truncated Huber: beyond 1e4×χ²th the loss is constant (zero influence) —
    # a single degenerate edge otherwise out-pulls every good observation
    # through Huber's linear tail (see solvers.pose_opt for the full story)
    trunc = 1e4 * chi2_th
    rho_cap = 2.0 * jnp.sqrt(chi2_th * trunc) - chi2_th

    def robust_cost(Tcw_, pts_, gate_):
        chi2 = _chi2(cam, prob, Tcw_, pts_)
        rho = jnp.where(
            chi2 <= chi2_th, chi2,
            2.0 * jnp.sqrt(chi2_th * jnp.maximum(chi2, 1e-12)) - chi2_th,
        )
        rho = jnp.minimum(rho, rho_cap)
        return jnp.sum(jnp.where(gate_, rho, 0.0))

    for n_iters in phase_iters:
        def body(_, carry):
            """Levenberg-Marquardt with step acceptance: reject steps that
            raise the robust cost and raise λ instead — lets short schedules
            keep full accuracy (plain damped GN needs the reference's full
            5+10 to converge)."""
            Tcw, pts, lam_c, cost = carry
            chi2 = _chi2(cam, prob, Tcw, pts)
            w = gate.astype(jnp.float32) * prob.inv_sigma2 * huber_weight(chi2, chi2_th)
            w = jnp.where(chi2 < trunc, w, 0.0)
            Tcw_new, pts_new = _solve_iteration(cam, prob, Tcw, pts, w, lam_c)
            cost_new = robust_cost(Tcw_new, pts_new, gate)
            accept = cost_new < cost
            Tcw = jnp.where(accept, Tcw_new, Tcw)
            pts = jnp.where(accept, pts_new, pts)
            cost = jnp.where(accept, cost_new, cost)
            lam_c = jnp.clip(jnp.where(accept, lam_c * 0.5, lam_c * 8.0), 1e-6, 1e3)
            return Tcw, pts, lam_c, cost

        carry = (Tcw, pts, jnp.asarray(lam, jnp.float32), robust_cost(Tcw, pts, gate))
        Tcw, pts, _, _ = jax.lax.fori_loop(0, n_iters, body, carry)
        chi2 = _chi2(cam, prob, Tcw, pts)
        gate = prob.edge_valid & (chi2 < chi2_th)

    return Tcw, pts, gate
