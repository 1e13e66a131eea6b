"""Global bundle adjustment: PCG on the Schur-reduced camera system.

The dense-S engine (solvers.schur_ba) is right for local windows, but a full
map has C ≈ 10³ keyframes and P ≈ 2.6·10⁵ landmarks — the camera-point
coupling matrix B is far too large to materialize.  This engine never forms
S: each Gauss-Newton step solves  S·dx = −b̃  by preconditioned conjugate
gradients.

**Dual-index, scatter-free design.**  The map keeps BOTH edge indexes: the
forward table ``kf_mp_idx [K, N]`` (camera-major) and the reverse observation
lists ``mp_obs_* [M, O]`` (point-major).  Every Schur reduction therefore has
a layout in which it is a plain axis-sum — no scatter, no one-hot:

    point-space sums (Hpp, b_p, Gᵀx)   → sum over O in the point-major planes
    camera-space sums (Hcc, b_c, G z)  → sum over N in the camera-major planes

with per-edge quantities stored feature-major (``[k, O, M]`` / ``[k, N, K]``
scalar planes, see solvers.edge_fm) so nothing hits the tile-padding cliff
that can make ``[M, O, 6, 6]`` tensors up to 28× their logical size.

The two index views MUST describe the same edge set or the implied S is
asymmetric and PCG diverges — extraction enforces backlink + membership
checks both ways (see ``global_ba.extract_global_problem``).

**Distribution** (replaces the reference's "no distributed backend",
SURVEY.md §5.8): shard points over the mesh axis on the point-major side and
cameras on the camera-major side.  Per matvec the only cross-device traffic
is one all-gather of the marginalized point vector ``z [3, M]`` (≈3 MB) and
one of the camera result ``y [6, K]`` (≈25 KB); per GN step one all-gather
each of Hcc/b̃/pt_pos.  The single-device path pays zero collective cost.

Replaces Optimizer::globalOptimization (reference src/Optimizer.cc:934-1043,
g2o LM with 10 iterations over the whole map).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..geometry import se3
from ..geometry.camera import CameraParams
from ..geometry.robust import huber_weight
from . import edge_fm


class PointBAProblem(NamedTuple):
    """Per-point edge layout: P point slots × O observations each.  Used
    directly by the local dense-Schur engine (schur_ba.solve_ba_points) and
    convertible to a GlobalBAProblem for the PCG engine."""

    cam_Tcw: jnp.ndarray      # f32[C, 4, 4]
    cam_free: jnp.ndarray     # bool[C]
    pt_pos: jnp.ndarray       # f32[P, 3]
    pt_valid: jnp.ndarray     # bool[P]
    obs_cam: jnp.ndarray      # i32[P, O] camera slot (−1 = none)
    obs_uv: jnp.ndarray       # f32[P, O, 2]
    obs_right_u: jnp.ndarray  # f32[P, O] (−1 = mono)
    obs_inv_sigma2: jnp.ndarray  # f32[P, O]
    obs_valid: jnp.ndarray    # bool[P, O]


class GlobalBAProblem(NamedTuple):
    """Dual-layout global BA problem.  Point-major arrays are obs-slot-major
    planes [.., O, M] (minor dim = points); camera-major arrays are
    feature-slot-major planes [.., N, K] (minor dim = cameras).  The two
    views must describe exactly the same edge set."""

    cam_Tcw: jnp.ndarray      # f32[K, 4, 4]
    cam_free: jnp.ndarray     # bool[K]
    pt_pos: jnp.ndarray       # f32[M, 3]
    pt_valid: jnp.ndarray     # bool[M]
    # point-major view
    pm_cam: jnp.ndarray       # i32[O, M] camera index (clipped; see pm_valid)
    pm_uv: jnp.ndarray        # f32[2, O, M]
    pm_right_u: jnp.ndarray   # f32[O, M]
    pm_inv_sigma2: jnp.ndarray  # f32[O, M]
    pm_valid: jnp.ndarray     # bool[O, M]
    # camera-major view
    cm_pt: jnp.ndarray        # i32[N, K] point index (clipped; see cm_valid)
    cm_uv: jnp.ndarray        # f32[2, N, K]
    cm_right_u: jnp.ndarray   # f32[N, K]
    cm_inv_sigma2: jnp.ndarray  # f32[N, K]
    cm_valid: jnp.ndarray     # bool[N, K]


def _chi2_point(cam, prob: PointBAProblem, Tcw, pts):
    """Per-observation χ² [P, O] for a PointBAProblem (feature-major
    internally — no [P, O, 3, 3] tensors)."""
    C = Tcw.shape[0]
    ci = jnp.clip(prob.obs_cam, 0, C - 1).T                  # [O, P]
    Rf = Tcw[:, :3, :3].reshape(C, 9).T
    tf = Tcw[:, :3, 3].T
    chi2 = edge_fm.edge_chi2(
        cam, Rf[:, ci], tf[:, ci], pts.T[:, None, :],
        jnp.transpose(prob.obs_uv, (2, 1, 0)), prob.obs_right_u.T,
        prob.obs_inv_sigma2.T,
    )
    return chi2.T


# --------------------------------------------------------------------------
# the dual-layout GN step
# --------------------------------------------------------------------------

def _pm_terms(cam, prob: GlobalBAProblem, Tcw, ptsT):
    """Point-major edge terms ([*, O, M] planes).  ``ptsT`` is [3, M_local]."""
    C = Tcw.shape[0]
    Rf = Tcw[:, :3, :3].reshape(C, 9).T
    tf = Tcw[:, :3, 3].T
    R9 = Rf[:, prob.pm_cam]
    t3 = tf[:, prob.pm_cam]
    return edge_fm.edge_terms(
        cam, R9, t3, ptsT[:, None, :], prob.pm_uv, prob.pm_right_u,
        prob.pm_inv_sigma2,
    )


def _local_cam_block(x, K_local: int, axis: Optional[str]):
    """Slice a replicated camera-axis array down to this shard's camera
    block (identity when unsharded)."""
    if axis is None or x.shape[0] == K_local:
        return x
    i = jax.lax.axis_index(axis)
    return jax.lax.dynamic_slice_in_dim(x, i * K_local, K_local, axis=0)


def _cm_terms(cam, prob: GlobalBAProblem, Tcw, ptsT_full, axis: Optional[str]):
    """Camera-major edge terms ([*, N, K] planes).  Camera pose broadcasts
    over the feature axis (no gather); points gather from the full map.
    ``Tcw`` may be the replicated full array — it is sliced to this shard's
    camera block."""
    Tcw = _local_cam_block(Tcw, prob.cm_pt.shape[1], axis)
    C = Tcw.shape[0]
    Rf = Tcw[:, :3, :3].reshape(C, 9).T[:, None, :]          # [9, 1, K]
    tf = Tcw[:, :3, 3].T[:, None, :]                         # [3, 1, K]
    pw3 = ptsT_full[:, prob.cm_pt]                           # [3, N, K]
    return edge_fm.edge_terms(
        cam, Rf, tf, pw3, prob.cm_uv, prob.cm_right_u, prob.cm_inv_sigma2,
    )


def _weights(chi2, gate, inv_sigma2, chi2_th):
    w = gate.astype(jnp.float32) * inv_sigma2 * huber_weight(chi2, chi2_th)
    return jnp.where(chi2 < 1e4 * chi2_th, w, 0.0)


def _gn_step(cam, prob: GlobalBAProblem, Tcw, ptsT, pm_gate, cm_gate,
             lam, pcg_iters, pm_th, cm_th, axis: Optional[str]):
    """One robust GN step with PCG-Schur solve.  ``ptsT`` [3, M_local] is the
    (possibly sharded) point block; Tcw and the returned dx are replicated."""
    C = Tcw.shape[0]

    def ag(x):  # all-gather along the trailing axis
        if axis is None:
            return x
        return jax.lax.all_gather(x, axis, axis=x.ndim - 1, tiled=True)

    # ---- point-major pass: Hpp, Wp, b_p, per-edge G ----------------------
    tm = _pm_terms(cam, prob, Tcw, ptsT)
    w_pm = _weights(tm.chi2, pm_gate, prob.pm_inv_sigma2, pm_th)
    free_pm = prob.cam_free[prob.pm_cam]
    tm = tm._replace(Jc=jnp.where(free_pm[None], tm.Jc, 0.0))

    Hpp6 = edge_fm.hpp_comps(tm, w_pm, reduce_axis=-2)       # [6, M]
    b_p3 = edge_fm.bp_comps(tm, w_pm, reduce_axis=-2)        # [3, M]
    lam_diag = jnp.zeros((6, 1)).at[jnp.asarray([0, 3, 5])].set(lam + 1e-9)
    Wp6 = edge_fm.sym3_inv(Hpp6 + lam_diag)
    Wp6 = jnp.where(prob.pt_valid[None, :], Wp6, 0.0)
    G_pm = edge_fm.g_comps(tm, w_pm)                         # [18, O, M]

    # ---- camera-major pass: Hcc, b_c, b̃, per-edge G ---------------------
    ptsT_full = ag(ptsT)                                     # [3, M_full]
    tc = _cm_terms(cam, prob, Tcw, ptsT_full, axis)
    w_cm = _weights(tc.chi2, cm_gate, prob.cm_inv_sigma2, cm_th)
    free_local = _local_cam_block(prob.cam_free, prob.cm_pt.shape[1], axis)
    tc = tc._replace(Jc=jnp.where(free_local[None, None, :], tc.Jc, 0.0))

    Hcc21 = ag(edge_fm.hcc_comps(tc, w_cm, reduce_axis=-2))  # [21, K]
    b_c = edge_fm.bc_comps(tc, w_cm, reduce_axis=-2)         # [6, K_local]
    G_cm = edge_fm.g_comps(tc, w_cm)                         # [18, N, K]

    # b̃ = b_c − Σ_n G · (Wp b_p)[point of edge]
    Wb = edge_fm.sym3_apply(Wp6, b_p3)                       # [3, M]
    Wb_full = ag(Wb)
    corr = jnp.sum(edge_fm.g_apply(G_cm, Wb_full[:, prob.cm_pt]), axis=-2)
    b_schur = ag(b_c - corr)                                 # [6, K]

    anchor = jnp.where(prob.cam_free, 0.0, 1.0)[None, :]     # [1, K]

    def matvec(x):  # x [6, K] replicated → y [6, K] replicated
        xg = x[:, prob.pm_cam]                               # [6, O, M]
        t_p = jnp.sum(edge_fm.gT_apply(G_pm, xg), axis=-2)   # [3, M]
        z = edge_fm.sym3_apply(Wp6, t_p)
        z_full = ag(z)
        u = jnp.sum(edge_fm.g_apply(G_cm, z_full[:, prob.cm_pt]), axis=-2)
        y_local = -u                                         # [6, K_local]
        y = ag(y_local)
        y = y + edge_fm.sym6_apply(Hcc21, x) + lam * x + anchor * x
        return y

    # Jacobi (block-diagonal) preconditioner from Hcc
    from .linalg_small import cholesky_solve_spd

    Hcc_p = edge_fm.sym6_to_dense(Hcc21) + (lam + 1.0) * jnp.eye(6)[None]

    def precond(v):  # [6, K]
        return cholesky_solve_spd(Hcc_p, v.T).T

    b = -b_schur

    def pcg_body(_, carry):
        x, rres, p, rz = carry
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = jnp.where(jnp.abs(denom) > 1e-12, rz / denom, 0.0)
        x = x + alpha * p
        rres = rres - alpha * Ap
        z = precond(rres)
        rz_new = jnp.sum(rres * z)
        beta = jnp.where(jnp.abs(rz) > 1e-12, rz_new / rz, 0.0)
        p = z + beta * p
        return x, rres, p, rz_new

    x0 = jnp.zeros_like(b)
    z0 = precond(b)
    carry = (x0, b, z0, jnp.sum(b * z0))
    dx_c, *_ = jax.lax.fori_loop(0, pcg_iters, pcg_body, carry)
    dx_c = jnp.where(jnp.isfinite(dx_c), dx_c, 0.0)
    dx_c = jnp.where(prob.cam_free[None, :], dx_c, 0.0)      # [6, K]

    # landmark back-substitution (local per point shard)
    xg = dx_c[:, prob.pm_cam]
    tp = jnp.sum(edge_fm.gT_apply(G_pm, xg), axis=-2)
    dx_p = edge_fm.sym3_apply(Wp6, b_p3 + tp)                # [3, M]
    dx_p = jnp.where(jnp.isfinite(dx_p), dx_p, 0.0)

    def apply(s):
        T = se3.normalize(se3.exp((s * dx_c).T) @ Tcw)
        return T, ptsT - s * dx_p

    # ---- monotone step acceptance (backtracking line search) -------------
    # Damped GN with a fixed lam can overshoot on ill-conditioned maps, and
    # unconverged float32 PCG makes the overshoot run-to-run noisy (sharded
    # vs unsharded compilations land visibly apart).  Accepting the best of
    # {full step, quarter step, hold} by the gated Huber cost makes every GN
    # step monotone in the robust objective, so neither path can degrade the
    # map.  Costs two extra point-major edge passes per step (~5% of the
    # PCG work).  The decision scalars are psum-reduced → identical on every
    # shard.
    c0 = _robust_cost(cam, prob, Tcw, ptsT, pm_gate, pm_th, axis)
    T1, p1 = apply(1.0)
    T2, p2 = apply(0.25)
    c1 = _robust_cost(cam, prob, T1, p1, pm_gate, pm_th, axis)
    c2 = _robust_cost(cam, prob, T2, p2, pm_gate, pm_th, axis)
    use1 = (c1 <= c2) & (c1 < c0)
    use2 = jnp.logical_not(use1) & (c2 < c0)
    Tcw_new = jnp.where(use1, T1, jnp.where(use2, T2, Tcw))
    ptsT_new = jnp.where(use1, p1, jnp.where(use2, p2, ptsT))
    return Tcw_new, ptsT_new


def _robust_cost(cam, prob: GlobalBAProblem, Tcw, ptsT, pm_gate, pm_th,
                 axis: Optional[str]):
    """Gated Huber total cost over the point-major edge view (each edge
    appears exactly once).  Replicated scalar: psum over the mesh axis."""
    chi2 = _pm_terms(cam, prob, Tcw, ptsT).chi2
    rho = jnp.where(
        chi2 <= pm_th,
        chi2,
        2.0 * jnp.sqrt(pm_th * jnp.maximum(chi2, 0.0)) - pm_th,
    )
    # cap at the 1e4·th weight cutoff (_weights zeroes those edges, so they
    # carry no gradient; letting their cost float would let a few astronomic
    # outliers both dominate the float32 sum and veto steps the solver can't
    # influence)
    rho = jnp.minimum(rho, 199.0 * pm_th)
    c = jnp.sum(jnp.where(pm_gate & prob.pm_valid, rho, 0.0))
    if axis is not None:
        c = jax.lax.psum(c, axis)
    return c


def _solve_global(cam, prob: GlobalBAProblem, *, chi2_mono, chi2_stereo,
                  phase_iters, pcg_iters, lam, axis: Optional[str]):
    pm_th = jnp.where(prob.pm_right_u > 0, chi2_stereo, chi2_mono)
    cm_th = jnp.where(prob.cm_right_u > 0, chi2_stereo, chi2_mono)
    Tcw = prob.cam_Tcw
    ptsT = prob.pt_pos.T                                     # [3, M_local]
    ptsT = jnp.where(prob.pt_valid[None, :], ptsT, ptsT)     # no-op; keep shape
    pm_gate = prob.pm_valid
    cm_gate = prob.cm_valid

    for n_iters in phase_iters:
        def body(_, carry):
            T, p = carry
            return _gn_step(cam, prob, T, p, pm_gate, cm_gate, lam,
                            pcg_iters, pm_th, cm_th, axis)

        Tcw, ptsT = jax.lax.fori_loop(0, n_iters, body, (Tcw, ptsT))
        pm_gate = prob.pm_valid & (_pm_terms(cam, prob, Tcw, ptsT).chi2 < pm_th)

        def ag(x):
            if axis is None:
                return x
            return jax.lax.all_gather(x, axis, axis=x.ndim - 1, tiled=True)

        cm_gate = prob.cm_valid & (
            _cm_terms(cam, prob, Tcw, ag(ptsT), axis).chi2 < cm_th
        )
    return Tcw, ptsT.T, pm_gate


# NOTE on damping: lam=0.1 matters even though _gn_step now has backtracking
# acceptance — at 1e-3 a map holding far-field stereo seeds (100 m+ points
# with metres of depth noise) overshoots so badly that most steps are
# rejected and the solve stalls (measured pre-acceptance: median reprojection
# chi2 74 -> 1315 at lam=1e-3 vs 74 -> 0.26 at lam=0.1 on a live loop-closed
# map); lam in [0.1, 1.0] is a wide safe plateau where full steps accept.


def global_ba_phase(
    cam: CameraParams,
    prob: GlobalBAProblem,
    Tcw: jnp.ndarray,
    ptsT: jnp.ndarray,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    n_iters: int = 1,
    pcg_iters: int = 40,
    lam: float = 0.1,
    robust_gate: bool = True,
    axis: Optional[str] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One resumable phase of the global BA: ``n_iters`` damped-GN steps from
    the given (Tcw, ptsT) iterate.  This is the chunk primitive behind the
    amortized background GBA (the reference runs its GBA on a transient
    thread and commits through mTcwGBA scratch, LoopClosing.cc:92-169,
    Optimizer.cc:1030-1042; here the solve is cut into per-idle-frame chunks
    instead).  ``robust_gate=False`` reproduces the ungated first phase of
    ``solve_global_ba``; subsequent chunks gate observations by the χ² of
    the entry iterate."""
    pm_th = jnp.where(prob.pm_right_u > 0, chi2_stereo, chi2_mono)
    cm_th = jnp.where(prob.cm_right_u > 0, chi2_stereo, chi2_mono)
    if robust_gate:
        pm_gate = prob.pm_valid & (_pm_terms(cam, prob, Tcw, ptsT).chi2 < pm_th)

        def ag(x):
            if axis is None:
                return x
            return jax.lax.all_gather(x, axis, axis=x.ndim - 1, tiled=True)

        cm_gate = prob.cm_valid & (
            _cm_terms(cam, prob, Tcw, ag(ptsT), axis).chi2 < cm_th
        )
    else:
        pm_gate, cm_gate = prob.pm_valid, prob.cm_valid

    def body(_, carry):
        T, p = carry
        return _gn_step(cam, prob, T, p, pm_gate, cm_gate, lam,
                        pcg_iters, pm_th, cm_th, axis)

    Tcw, ptsT = jax.lax.fori_loop(0, n_iters, body, (Tcw, ptsT))
    return Tcw, ptsT


def solve_global_ba(
    cam: CameraParams,
    prob,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    phase_iters: Tuple[int, int] = (5, 5),
    pcg_iters: int = 40,
    lam: float = 0.1,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Two-phase robust global BA (gate between phases, mirroring the
    reference's 10-iteration global g2o run, Optimizer.cc:934-1043).
    Accepts a GlobalBAProblem (or a PointBAProblem, converted on the host).
    Returns (cam_Tcw, pt_pos, obs_inlier [O, M] point-major)."""
    if isinstance(prob, PointBAProblem):
        prob = point_to_global(prob)
    return _solve_global(
        cam, prob, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
        phase_iters=phase_iters, pcg_iters=pcg_iters, lam=lam, axis=None,
    )


def solve_global_ba_sharded(
    cam: CameraParams,
    prob,
    mesh: Mesh,
    axis: str = "ba",
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    phase_iters: Tuple[int, int] = (5, 5),
    pcg_iters: int = 40,
    lam: float = 0.1,
):
    """Distributed global BA: point-major arrays sharded over points,
    camera-major arrays over cameras, reductions stitched with all-gathers
    across the mesh (SURVEY.md §5.8)."""
    from jax import shard_map

    if isinstance(prob, PointBAProblem):
        prob = point_to_global(prob)

    n_dev = mesh.shape[axis]
    K0 = int(prob.cam_Tcw.shape[0])
    M0 = int(prob.pt_pos.shape[0])
    prob = _pad_global(prob, n_dev)

    last = P(None, None, axis)
    in_specs = GlobalBAProblem(
        cam_Tcw=P(), cam_free=P(),
        pt_pos=P(axis, None), pt_valid=P(axis),
        pm_cam=P(None, axis), pm_uv=last, pm_right_u=P(None, axis),
        pm_inv_sigma2=P(None, axis), pm_valid=P(None, axis),
        cm_pt=P(None, axis), cm_uv=last, cm_right_u=P(None, axis),
        cm_inv_sigma2=P(None, axis), cm_valid=P(None, axis),
    )

    def run(p):
        return _solve_global(
            cam, p, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
            phase_iters=phase_iters, pcg_iters=pcg_iters, lam=lam, axis=axis,
        )

    fn = shard_map(
        run, mesh=mesh,
        in_specs=(in_specs,),
        out_specs=(P(), P(axis, None), P(None, axis)),
        # Tcw is reconstructed identically on every shard from all-gathered
        # pieces; the static varying-axis checker can't prove that.
        check_vma=False,
    )
    Tcw, pts, gate = jax.jit(fn)(prob)
    return Tcw[:K0], pts[:M0], gate[:, :M0]


def _pad_global(prob: GlobalBAProblem, n_dev: int) -> GlobalBAProblem:
    """Pad the camera axis (minor dim of cm_* / cam arrays) and the point
    axis (minor dim of pm_* / pt arrays) up to multiples of the mesh axis
    size; padded slots are fixed/invalid and contribute nothing."""
    K = int(prob.cam_Tcw.shape[0])
    M = int(prob.pt_pos.shape[0])
    Kp = (-K) % n_dev
    Mp = (-M) % n_dev
    if Kp == 0 and Mp == 0:
        return prob

    def pad_last(x, n, val=0):
        if n == 0:
            return x
        widths = [(0, 0)] * (x.ndim - 1) + [(0, n)]
        return jnp.pad(x, widths, constant_values=val)

    eye = jnp.broadcast_to(jnp.eye(4, dtype=prob.cam_Tcw.dtype), (Kp, 4, 4))
    return GlobalBAProblem(
        cam_Tcw=jnp.concatenate([prob.cam_Tcw, eye]) if Kp else prob.cam_Tcw,
        cam_free=pad_last(prob.cam_free, Kp, False),
        pt_pos=jnp.pad(prob.pt_pos, ((0, Mp), (0, 0))) if Mp else prob.pt_pos,
        pt_valid=pad_last(prob.pt_valid, Mp, False),
        pm_cam=pad_last(prob.pm_cam, Mp),
        pm_uv=pad_last(prob.pm_uv, Mp),
        pm_right_u=pad_last(prob.pm_right_u, Mp, -1.0),
        pm_inv_sigma2=pad_last(prob.pm_inv_sigma2, Mp, 1.0),
        pm_valid=pad_last(prob.pm_valid, Mp, False),
        cm_pt=pad_last(prob.cm_pt, Kp),
        cm_uv=pad_last(prob.cm_uv, Kp),
        cm_right_u=pad_last(prob.cm_right_u, Kp, -1.0),
        cm_inv_sigma2=pad_last(prob.cm_inv_sigma2, Kp, 1.0),
        cm_valid=pad_last(prob.cm_valid, Kp, False),
    )


# --------------------------------------------------------------------------
# conversion (host-side; tests / dry-runs build PointBAProblems directly)
# --------------------------------------------------------------------------

def point_to_global(prob: PointBAProblem, n_feat: Optional[int] = None,
                    round_to: int = 8) -> GlobalBAProblem:
    """Build the camera-major view from a point-major problem (host-side
    numpy).  The camera-major feature capacity is the max per-camera edge
    count (rounded up); the edge SETS of the two views are identical by
    construction."""
    obs_cam = np.asarray(prob.obs_cam)
    obs_valid = np.asarray(prob.obs_valid) & (obs_cam >= 0) & np.asarray(prob.pt_valid)[:, None]
    Pn, O = obs_cam.shape
    C = int(prob.cam_Tcw.shape[0])

    uv = np.asarray(prob.obs_uv)
    ru = np.asarray(prob.obs_right_u)
    iv = np.asarray(prob.obs_inv_sigma2)

    counts = np.zeros(C, np.int64)
    pe, oe = np.nonzero(obs_valid)
    ce = obs_cam[pe, oe]
    # sequential slot per camera
    order = np.argsort(ce, kind="stable")
    pe, oe, ce = pe[order], oe[order], ce[order]
    counts = np.bincount(ce, minlength=C)
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(ce)) - starts[ce]
    N = int(max(8, counts.max() if len(counts) else 0)) if n_feat is None else n_feat
    N = ((N + round_to - 1) // round_to) * round_to

    cm_pt = np.zeros((N, C), np.int32)
    cm_uv = np.zeros((2, N, C), np.float32)
    cm_ru = np.full((N, C), -1.0, np.float32)
    cm_iv = np.ones((N, C), np.float32)
    cm_ok = np.zeros((N, C), bool)
    keep = slot < N
    cm_pt[slot[keep], ce[keep]] = pe[keep]
    cm_uv[0, slot[keep], ce[keep]] = uv[pe[keep], oe[keep], 0]
    cm_uv[1, slot[keep], ce[keep]] = uv[pe[keep], oe[keep], 1]
    cm_ru[slot[keep], ce[keep]] = ru[pe[keep], oe[keep]]
    cm_iv[slot[keep], ce[keep]] = iv[pe[keep], oe[keep]]
    cm_ok[slot[keep], ce[keep]] = True
    # an edge dropped from the camera-major view must drop from both
    pm_ok = obs_valid.copy()
    if not keep.all():
        pm_ok[pe[~keep], oe[~keep]] = False

    return GlobalBAProblem(
        cam_Tcw=prob.cam_Tcw, cam_free=prob.cam_free,
        pt_pos=prob.pt_pos, pt_valid=prob.pt_valid,
        pm_cam=jnp.asarray(np.clip(obs_cam, 0, C - 1).T),
        pm_uv=jnp.asarray(np.transpose(uv, (2, 1, 0))),
        pm_right_u=jnp.asarray(ru.T),
        pm_inv_sigma2=jnp.asarray(iv.T),
        pm_valid=jnp.asarray(pm_ok.T),
        cm_pt=jnp.asarray(cm_pt),
        cm_uv=jnp.asarray(cm_uv),
        cm_right_u=jnp.asarray(cm_ru),
        cm_inv_sigma2=jnp.asarray(cm_iv),
        cm_valid=jnp.asarray(cm_ok),
    )
