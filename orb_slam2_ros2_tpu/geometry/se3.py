"""SE(3) rigid transforms as batched JAX arrays.

The reference stores poses as ``cv::Mat`` 4×4 (Tcw / Twc caches under a mutex,
reference: include/ORB_SLAM2/Frame.h:141-201) and converts to g2o
``SE3Quat`` for optimization (src/Optimizer.cc:628-718).  Here a pose is a
plain ``f32[..., 4, 4]`` array — functional, batched, jit-friendly — plus
exp/log maps on the se(3) tangent space used by the Gauss-Newton solvers.

Tangent convention: ``xi = [rho, phi]`` (translation first, rotation second),
``exp(xi) = [[exp(phi^), V rho], [0, 1]]`` — matching g2o's SE3Quat ordering so
the solver update ``T <- exp(dx) * T`` mirrors the reference optimizer.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def identity(batch: tuple = ()) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (*batch, 4, 4))


def from_Rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Build [..., 4, 4] from R [..., 3, 3] and t [..., 3]."""
    batch = R.shape[:-2]
    T = jnp.zeros((*batch, 4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def R_of(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, :3]


def t_of(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, 3]


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE3 inverse: [R^T, -R^T t]."""
    R = R_of(T)
    t = t_of(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return from_Rt(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return A @ B


def apply(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Transform points p [..., 3] by T [..., 4, 4] (broadcasting)."""
    return jnp.einsum("...ij,...j->...i", R_of(T), p) + t_of(T)


def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat: [..., 3] -> [..., 3, 3] skew matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: [..., 3] -> [..., 3, 3].  Series expansion near zero."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2 + _EPS)
    K = hat(phi)
    K2 = K @ K
    # sin(θ)/θ and (1-cos(θ))/θ² with Taylor fallbacks
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    I = jnp.eye(3, dtype=phi.dtype)
    return I + a * K + b * K2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> [..., 3].  Safe for angles in [0, π).

    Uses θ = atan2(‖w‖, tr−1) with w the skew part (‖w‖ = 2 sin θ), which is
    well-conditioned everywhere except θ≈π — unlike the arccos form, whose
    derivative blows up already at moderate angles in f32.
    """
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    # smooth norm: ‖w‖ has a NaN gradient at w = 0 (identity rotation), which
    # poisons jax.jacfwd through any residual that passes through log∘exp —
    # the epsilon keeps value AND derivative finite (d√(x+ε)·dx/dw → 0 at 0).
    w_norm = jnp.sqrt(jnp.sum(w * w, axis=-1) + 1e-24)  # = 2 sin θ
    theta = jnp.arctan2(w_norm, trace - 1.0)
    small = w_norm < 1e-6
    # θ/(2 sin θ) with series fallback 1/2 + θ²/12 near zero
    scale = jnp.where(
        small, 0.5 + theta * theta / 12.0, theta / jnp.maximum(w_norm, 1e-12)
    )
    return w * scale[..., None]


def _V(phi: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian of SO(3): V such that exp([rho,phi]) translation = V rho."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2 + _EPS)
    K = hat(phi)
    K2 = K @ K
    small = theta2 < 1e-8
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta))
    I = jnp.eye(3, dtype=phi.dtype)
    return I + b * K + c * K2


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exp: [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = jnp.einsum("...ij,...j->...i", _V(phi), rho)
    return from_Rt(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """se(3) log: [..., 4, 4] -> [..., 6] (rho, phi)."""
    phi = so3_log(R_of(T))
    Vinv = jnp.linalg.inv(_V(phi))
    rho = jnp.einsum("...ij,...j->...i", Vinv, t_of(T))
    return jnp.concatenate([rho, phi], axis=-1)


def normalize(T: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize the rotation block (drift control).

    Quaternion round-trip instead of an SVD: ``jnp.linalg.svd`` on 3×3 lowers
    to an iterative routine; the closed-form
    rot→quat→normalize→rot projection is a handful of vector ops and is
    exact for rotations already near SO(3).
    """
    from ..solvers.linalg_small import quat_to_rot, rot_to_quat

    q = rot_to_quat(R_of(T))
    return from_Rt(quat_to_rot(q), t_of(T))
