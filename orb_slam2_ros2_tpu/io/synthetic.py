"""Synthetic textured-box world renderer (new; no reference counterpart).

The environment ships no KITTI/TUM data, so tests and benchmarks render a
deterministic synthetic stereo sequence with exact ground-truth poses and
depth: the camera flies through a closed textured box; every pixel ray is
intersected with the six box planes and shaded with blocky multi-octave
value noise (sharp edges → plenty of FAST corners).  Fully vectorized jax —
renders on-device for the benchmark.

World frame: x right, y down, z forward (camera convention at identity).
Box interior: x ∈ [−8, 8], y ∈ [−3, 1.5], z ∈ [−5, 200].
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3

BOX_MIN = np.array([-8.0, -3.0, -5.0], np.float32)
BOX_MAX = np.array([8.0, 1.5, 200.0], np.float32)


def _hash3(ix: jnp.ndarray, iy: jnp.ndarray, iz: jnp.ndarray) -> jnp.ndarray:
    """Integer lattice hash → [0, 1) f32 (deterministic, branch-free)."""
    h = (
        ix.astype(jnp.uint32) * jnp.uint32(0x8DA6B343)
        + iy.astype(jnp.uint32) * jnp.uint32(0xD8163841)
        + iz.astype(jnp.uint32) * jnp.uint32(0xCB1AB31F)
    )
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0x9E3779B1)
    h = h ^ (h >> 16)
    return (h & jnp.uint32(0xFFFF)).astype(jnp.float32) / 65536.0


def _texture(p: jnp.ndarray) -> jnp.ndarray:
    """Blocky 3-octave value noise in [0, 255] for world points [..., 3]."""
    out = 0.0
    amp = 1.0
    freq = 1.5
    total = 0.0
    for _ in range(3):
        q = jnp.floor(p * freq)
        out = out + amp * _hash3(q[..., 0], q[..., 1], q[..., 2])
        total += amp
        amp *= 0.5
        freq *= 2.7
    return 255.0 * out / total


@partial(jax.jit, static_argnames=("h", "w", "box_scale", "sky"))
def render(
    K_inv: jnp.ndarray, Twc: jnp.ndarray, h: int, w: int,
    box_scale: float = 1.0, sky: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Render (image [h, w] f32 in [0,255], depth [h, w] f32 in camera z).

    ``box_scale`` widens the box's x/y extents (z unchanged): 1.0 is the
    close-quarters default; ~1.6 matches KITTI-00's depth statistics
    (building facades 10–30 m) so the KF-cadence logic sees a KITTI-like
    close-point distribution.  ``sky=True`` renders far level-or-upward
    geometry featureless (KITTI: ~40% of features have no stereo depth;
    a fully-enclosed textured box gives depth to ~everything, which inflates
    the mature-point counts the keyframe-cadence ratio divides by)."""
    us = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    vs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    pix = jnp.stack([us, vs, jnp.ones_like(us)], axis=-1)
    rays_c = jnp.einsum("ij,hwj->hwi", K_inv, pix)
    R, t = se3.R_of(Twc), se3.t_of(Twc)
    rays_w = jnp.einsum("ij,hwj->hwi", R, rays_c)
    origin = t

    sxy = np.array([box_scale, box_scale, 1.0], np.float32)
    bmin, bmax = BOX_MIN * sxy, BOX_MAX * sxy
    t_best = jnp.full((h, w), jnp.inf)
    for axis in range(3):
        for bound in (bmin[axis], bmax[axis]):
            d = rays_w[..., axis]
            safe_d = jnp.where(jnp.abs(d) > 1e-9, d, 1e-9)
            t_hit = (bound - origin[axis]) / safe_d
            # valid forward hit; keep nearest
            ok = t_hit > 1e-3
            t_best = jnp.where(ok & (t_hit < t_best), t_hit, t_best)

    hit = origin + t_best[..., None] * rays_w
    img = _texture(hit)
    depth = t_best * rays_c[..., 2]  # camera-frame z = t * (unit-z component)
    if sky:
        vs_f = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        far = (depth > 60.0) & (rays_w[..., 1] < 0.03)
        img = jnp.where(far, 96.0 + 40.0 * vs_f / h, img)
    # Optical PSF: real cameras never deliver razor-sharp block edges.  Without
    # this blur the SAD sub-pixel refinement pixel-locks on the aliased texture
    # and stereo depth develops a camera-position-dependent bias.
    from ..ops.pyramid import gaussian_blur

    img = gaussian_blur(img, ksize=5, sigma=1.0)
    return img, depth


@partial(jax.jit, static_argnames=("h", "w", "sky", "n_distractors", "exposure", "repeat_texture"))
def render_adversarial(
    K_inv: jnp.ndarray,
    Twc: jnp.ndarray,
    h: int,
    w: int,
    t: jnp.ndarray,
    *,
    sky: bool = True,
    n_distractors: int = 4,
    exposure: bool = True,
    repeat_texture: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Adversarial variant of ``render`` (r2 VERDICT next#4) — the benign box
    world plus the failure modes real sequences have:

    - **depthless sky**: surfaces beyond 60 m render as a smooth gradient —
      no FAST corners, no stereo disparity (KITTI sky / TUM far field);
    - **moving distractors**: floating textured spheres on oscillating paths
      whose surface pattern also slides over time — violates the static-world
      assumption exactly like pedestrians/vehicles;
    - **exposure ramp**: multiplicative gain + additive bias varying per
      frame (auto-exposure flicker);
    - **repeated texture**: the +x wall's texture tiles every few metres
      (perceptual aliasing — a corridor of identical posters) to attack
      place recognition.
    """
    us = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    vs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    pix = jnp.stack([us, vs, jnp.ones_like(us)], axis=-1)
    rays_c = jnp.einsum("ij,hwj->hwi", K_inv, pix)
    R, tr = se3.R_of(Twc), se3.t_of(Twc)
    rays_w = jnp.einsum("ij,hwj->hwi", R, rays_c)
    origin = tr

    t_best = jnp.full((h, w), jnp.inf)
    for axis in range(3):
        for bound in (BOX_MIN[axis], BOX_MAX[axis]):
            d = rays_w[..., axis]
            safe_d = jnp.where(jnp.abs(d) > 1e-9, d, 1e-9)
            t_hit = (bound - origin[axis]) / safe_d
            ok = t_hit > 1e-3
            t_best = jnp.where(ok & (t_hit < t_best), t_hit, t_best)

    # moving distractor spheres (closest-hit override), placed on a ring
    # OUTSIDE the validation trajectories' circle (radius 4 around
    # [0, 0, 15]) so they occlude parts of the view like pedestrians/vehicles
    # without ever swallowing it whole
    obj_id = jnp.zeros((h, w), jnp.int32)  # 0 = static world
    if n_distractors > 0:
        for j in range(n_distractors):
            ang = 2.0 * np.pi * j / n_distractors + 0.7
            base = jnp.asarray([
                7.0 * np.sin(ang), -1.0 + 0.6 * (j % 3),
                15.0 - 7.0 * np.cos(ang),
            ], jnp.float32)
            amp = jnp.asarray([0.8, 0.5, 0.8], jnp.float32)
            wfreq = 0.11 + 0.037 * j
            centre = base + amp * jnp.sin(wfreq * t + j)
            radius = 0.6 + 0.25 * (j % 3)
            oc = origin - centre
            a_ = jnp.sum(rays_w * rays_w, axis=-1)  # rays are NOT unit length
            b_ = jnp.einsum("hwi,i->hw", rays_w, oc)
            c_ = jnp.dot(oc, oc) - radius * radius
            disc = b_ * b_ - a_ * c_
            t_sph = (-b_ - jnp.sqrt(jnp.maximum(disc, 0.0))) / a_
            hit_ok = (disc > 0) & (t_sph > 1e-3) & (t_sph < t_best)
            t_best = jnp.where(hit_ok, t_sph, t_best)
            obj_id = jnp.where(hit_ok, j + 1, obj_id)

    hit = origin + t_best[..., None] * rays_w
    # repeated texture: tile the UPPER BAND of the +x wall every 5 m along z
    # (a corridor of identical posters — perceptual aliasing for place
    # recognition; the lower band stays unique so frame-to-frame matching is
    # degraded, not voided, when the wall fills the view)
    if repeat_texture:
        on_wall = (hit[..., 0] > BOX_MAX[0] - 0.1) & (hit[..., 1] < -0.5)
        tiled_z = jnp.mod(hit[..., 2], 5.0)
        hit_tex = jnp.where(
            on_wall[..., None],
            jnp.stack([hit[..., 0], hit[..., 1], tiled_z], axis=-1),
            hit,
        )
    else:
        hit_tex = hit
    # distractor surfaces: object-local, slowly time-sliding texture
    # coordinates — the pattern must stereo-match WITHIN a frame (so the
    # spheres become map points that then move, violating the static-world
    # assumption) while drifting across frames
    oid = obj_id.astype(jnp.float32)
    slide = jnp.stack([
        jnp.broadcast_to(0.15 * t, oid.shape), 11.0 * oid,
        jnp.broadcast_to(0.07 * t, oid.shape),
    ], axis=-1)
    hit_tex = jnp.where((obj_id > 0)[..., None], hit + slide, hit_tex)
    img = _texture(hit_tex)

    depth = t_best * rays_c[..., 2]
    if sky:
        # depthless sky: far geometry seen along level-or-upward rays renders
        # featureless (KITTI-style: road texture continues to the horizon,
        # the upper far field is blank sky; y is down in this convention)
        far = (depth > 60.0) & (rays_w[..., 1] < 0.03)
        gradient = 96.0 + 40.0 * vs / h
        img = jnp.where(far, gradient, img)

    from ..ops.pyramid import gaussian_blur

    img = gaussian_blur(img, ksize=5, sigma=1.0)
    if exposure:
        gain = 1.0 + 0.25 * jnp.sin(0.17 * t)
        bias = 9.0 * jnp.sin(0.05 * t + 1.0)
        img = jnp.clip(img * gain + bias, 0.0, 255.0)
    return img, depth


def circle_trajectory(n_frames: int, radius: float = 4.0, z_center: float = 15.0) -> np.ndarray:
    """Closed circular trajectory (camera yaws along the tangent): the last
    poses revisit the first — exercises loop closure."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / (n_frames - 4)  # slight overshoot → revisit
        c, s = np.cos(a), np.sin(a)
        centre = np.array([radius * s, 0.0, z_center - radius * c], np.float32)
        yaw = a
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = centre
        poses.append(T)
    return np.stack(poses)


def trajectory(n_frames: int, speed: float = 0.8, yaw_rate: float = 0.002) -> np.ndarray:
    """Ground-truth Twc poses [n, 4, 4]: forward motion with gentle yaw."""
    poses = []
    T = np.eye(4, dtype=np.float32)
    for i in range(n_frames):
        poses.append(T.copy())
        yaw = yaw_rate * np.sin(i * 0.05)
        c, s = np.cos(yaw), np.sin(yaw)
        dR = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        step = np.eye(4, dtype=np.float32)
        step[:3, :3] = dR
        step[:3, 3] = [0.0, 0.0, speed]
        T = T @ step
    return np.stack(poses)


class SyntheticStereoDataset:
    """Iterable synthetic stereo sequence with ground truth.

    Mirrors the role of the reference's KITTI example driver
    (example/Stereo/KittiStereo.cc) for environments without data.
    """

    def __init__(self, cam_cfg, n_frames: int = 100, speed: float = 0.8,
                 circle: bool = False, box_scale: float = 1.0,
                 sky: bool = False):
        self.cfg = cam_cfg
        self.poses_wc = circle_trajectory(n_frames) if circle else trajectory(n_frames, speed)
        K = np.array(
            [[cam_cfg.fx, 0, cam_cfg.cx], [0, cam_cfg.fy, cam_cfg.cy], [0, 0, 1]],
            np.float32,
        )
        self.K_inv = jnp.asarray(np.linalg.inv(K))
        self.n_frames = n_frames
        self.box_scale = box_scale
        self.sky = sky

    def __len__(self):
        return self.n_frames

    def frame(self, i: int):
        """Returns (img_left, img_right, Twc_gt) — images [H, W] f32."""
        Twc = jnp.asarray(self.poses_wc[i])
        imgL, _ = render(self.K_inv, Twc, self.cfg.height, self.cfg.width,
                         self.box_scale, self.sky)
        right_offset = jnp.eye(4).at[0, 3].set(self.cfg.baseline)
        Twc_r = Twc @ right_offset
        imgR, _ = render(self.K_inv, Twc_r, self.cfg.height, self.cfg.width,
                         self.box_scale, self.sky)
        return imgL, imgR, np.asarray(self.poses_wc[i])

    def frame_with_depth(self, i: int):
        Twc = jnp.asarray(self.poses_wc[i])
        imgL, depth = render(self.K_inv, Twc, self.cfg.height, self.cfg.width)
        return imgL, depth, np.asarray(self.poses_wc[i])


def multi_lap_circle_trajectory(
    n_frames: int, frames_per_lap: int, radius: float = 4.0, z_center: float = 15.0
) -> np.ndarray:
    """Circular trajectory that keeps going around — ``n_frames`` frames at
    ``frames_per_lap`` per revolution, i.e. ⌊n/lap⌋ revisits of every spot
    (the ≥2-loop-revisit validation trajectory, r2 VERDICT next#4)."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / frames_per_lap
        c, s = np.cos(a), np.sin(a)
        centre = np.array([radius * s, 0.0, z_center - radius * c], np.float32)
        cy, sy = np.cos(a), np.sin(a)
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = centre
        poses.append(T)
    return np.stack(poses)


class AdversarialStereoDataset:
    """Adversarial synthetic stereo sequence: the benign box world plus
    depthless sky, moving distractors, exposure flicker and repeated texture
    (see ``render_adversarial``), on a multi-lap circle with ≥2 revisits of
    every spot.  Same ``frame(i)`` interface as SyntheticStereoDataset."""

    def __init__(
        self,
        cam_cfg,
        n_frames: int = 500,
        frames_per_lap: int = 52,
        *,
        sky: bool = True,
        n_distractors: int = 4,
        exposure: bool = True,
        repeat_texture: bool = True,
    ):
        self.cfg = cam_cfg
        self.poses_wc = multi_lap_circle_trajectory(n_frames, frames_per_lap)
        self.frames_per_lap = frames_per_lap
        K = np.array(
            [[cam_cfg.fx, 0, cam_cfg.cx], [0, cam_cfg.fy, cam_cfg.cy], [0, 0, 1]],
            np.float32,
        )
        self.K_inv = jnp.asarray(np.linalg.inv(K))
        self.n_frames = n_frames
        self.flags = dict(sky=sky, n_distractors=n_distractors,
                          exposure=exposure, repeat_texture=repeat_texture)

    def __len__(self):
        return self.n_frames

    def frame(self, i: int):
        Twc = jnp.asarray(self.poses_wc[i])
        tj = jnp.asarray(float(i), jnp.float32)
        imgL, _ = render_adversarial(
            self.K_inv, Twc, self.cfg.height, self.cfg.width, tj, **self.flags
        )
        right_offset = jnp.eye(4).at[0, 3].set(self.cfg.baseline)
        imgR, _ = render_adversarial(
            self.K_inv, Twc @ right_offset, self.cfg.height, self.cfg.width,
            tj, **self.flags
        )
        return imgL, imgR, np.asarray(self.poses_wc[i])
