"""Tracking front end: host state machine over fused jitted stages.

The reference's ``Tracking::grabFrame`` runs a per-frame pipeline of feature
extraction → motion-model / reference-KF / relocalization tracking → local-map
tracking → keyframe decision, as CPU loops with per-object locks (reference:
src/Tracking.cc:52-164 and SURVEY.md §3.2).  Here each stage is a jitted
batched program; the host only sequences them and holds tiny scalars
(state enum, velocity).  This module provides the motion-model odometry core;
local-map tracking and relocalization attach in the pipeline.system layer.

States mirror the reference enum (Tracking.h:12-18):
NOT_IMAGE_YET → NOT_INITING → OK ⇄ LOST.
"""

from __future__ import annotations

import enum
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SLAMConfig
from ..features.frame import StereoFrame
from ..geometry import se3
from ..geometry.camera import CameraParams, unproject
from ..matching import matcher
from ..solvers.pose_opt import PoseObs, optimize_pose


class TrackState(enum.Enum):
    NOT_IMAGE_YET = 0
    NOT_INITING = 1
    OK = 2
    LOST = 3


class TrackedFrame(NamedTuple):
    """Device-resident per-frame tracking state handed between steps."""

    frame: StereoFrame
    Tcw: jnp.ndarray      # f32[4, 4]
    pw: jnp.ndarray       # f32[N, 3] world points unprojected from stereo depth
    has_pw: jnp.ndarray   # bool[N]


def unproject_frame(cam: CameraParams, frame: StereoFrame, Tcw: jnp.ndarray):
    """Per-keypoint world points from stereo depth (the reference's temporary
    map points for the last frame, Tracking.cc:685-694)."""
    ok = frame.feats.valid & (frame.depth > 0.0)
    pc = unproject(cam, frame.feats.uv, jnp.where(ok, frame.depth, 1.0))
    pw = se3.apply(se3.inverse(Tcw), pc)
    return pw, ok


def motion_track_step(
    cam: CameraParams,
    cur: StereoFrame,
    last: TrackedFrame,
    velocity: jnp.ndarray,
    *,
    radius: float,
    scale_factor: float,
    n_levels: int,
    baseline: float,
    max_dist: int,
    ratio: float,
    sigma2_base: float,
    chi2_mono: float,
    chi2_stereo: float,
    pose_rounds: int = 4,
    pose_iters: int = 10,
):
    """One fused motion-model tracking step.

    Matches the reference's trackMotionModel (Tracking.cc:381-406): predict
    pose with the velocity model, match last-frame keypoints (those carrying
    3D) to current keypoints around their image positions with
    forward/backward octave logic, then pose-only optimize.

    Returns (Tcw_opt, n_matches, n_inliers, obs_pw, obs_idx) — the matched
    observation set is reused by the caller for map bookkeeping.
    """
    Tcw_pred = velocity @ last.Tcw
    # z of current-camera origin in last camera frame decides forward/backward
    twc_cur = se3.t_of(se3.inverse(Tcw_pred))
    z_forward = se3.apply(last.Tcw, twc_cur[None])[0, 2]

    m = matcher.search_by_area(
        last.frame.feats, last.has_pw, cur.feats,
        jnp.zeros((cur.feats.capacity,), bool), z_forward,
        radius=radius, scale_factor=scale_factor, n_levels=n_levels,
        baseline=baseline, max_dist=max_dist, ratio=ratio,
    )
    n_matches = jnp.sum(m.found.astype(jnp.int32))

    cidx = jnp.maximum(m.idx, 0)
    uv = cur.feats.uv[cidx]
    right_u = cur.right_u[cidx]
    octave = cur.feats.octave[cidx]
    inv_sigma2 = jnp.power(jnp.float32(1.0 / (sigma2_base)), octave.astype(jnp.float32))
    obs = PoseObs(
        pw=last.pw,
        uv=uv,
        right_u=right_u,
        inv_sigma2=inv_sigma2,
        is_stereo=right_u > 0,
        valid=m.found,
    )
    Tcw_opt, inlier, n_inliers = optimize_pose(
        cam, Tcw_pred, obs, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
        rounds=pose_rounds, iters_per_round=pose_iters,
    )
    return Tcw_opt, n_matches, n_inliers, m, inlier


def make_fused_odometry_step(cfg: SLAMConfig):
    """One fully device-resident frame step: images in → pose + new state out.

    Fuses the stereo frontend, motion-model matching, pose-only GN and the
    state update into a single jitted program — the per-frame hot path of
    SURVEY.md §3.2 as one XLA computation, with zero host round-trips inside
    the frame loop.
    """
    from ..features.extractor import make_stereo_frontend

    o, c, m, t, b = cfg.orb, cfg.camera, cfg.matcher, cfg.tracking, cfg.ba
    frontend_fn = make_stereo_frontend(cfg)

    def step(cam: CameraParams, img_l, img_r, last: TrackedFrame, velocity):
        cur = frontend_fn(img_l, img_r, cam)
        Tcw, n_matches, n_inliers, _, _ = motion_track_step(
            cam, cur, last, velocity,
            radius=t.motion_search_radius, scale_factor=o.scale_factor,
            n_levels=o.n_levels, baseline=c.baseline, max_dist=m.min_threshold,
            ratio=m.nn_ratio_track, sigma2_base=o.scale_factor * o.scale_factor,
            chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
            pose_rounds=b.pose_rounds, pose_iters=b.pose_iters_per_round,
        )
        velocity_new = Tcw @ se3.inverse(last.Tcw)
        pw, has = unproject_frame(cam, cur, Tcw)
        new_last = TrackedFrame(frame=cur, Tcw=Tcw, pw=pw, has_pw=has)
        return new_last, velocity_new, Tcw, n_matches, n_inliers

    return jax.jit(step, donate_argnums=(3,))


class OdometryTracker:
    """Stereo visual odometry: the minimum end-to-end slice (SURVEY.md §7.4).

    Motion-model tracking against the previous frame's stereo-unprojected
    points.  The full System adds mapping, local-map tracking, relocalization
    and loop closing on top of this core.
    """

    def __init__(self, cfg: SLAMConfig, cam: Optional[CameraParams] = None):
        self.cfg = cfg
        self.cam = cam if cam is not None else CameraParams.from_config(cfg.camera)
        o, c, m, t, b = cfg.orb, cfg.camera, cfg.matcher, cfg.tracking, cfg.ba
        common = dict(
            scale_factor=o.scale_factor, n_levels=o.n_levels, baseline=c.baseline,
            max_dist=m.min_threshold, ratio=m.nn_ratio_track,
            sigma2_base=o.scale_factor * o.scale_factor,
            chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
            pose_rounds=b.pose_rounds, pose_iters=b.pose_iters_per_round,
        )
        self._step = jax.jit(partial(motion_track_step, radius=t.motion_search_radius, **common))
        self._step_wide = jax.jit(partial(motion_track_step, radius=t.motion_search_radius * 2, **common))
        self._unproject = jax.jit(unproject_frame)
        self.state = TrackState.NOT_IMAGE_YET
        self.last: Optional[TrackedFrame] = None
        self.velocity = jnp.eye(4, dtype=jnp.float32)
        self.min_matches = t.min_motion_matches
        self.min_inliers = t.min_track_inliers

    def track(self, frame: StereoFrame) -> Tuple[Optional[np.ndarray], dict]:
        """Feed one frame; returns (Tcw as numpy or None if lost, info)."""
        info = {}
        if self.state in (TrackState.NOT_IMAGE_YET, TrackState.NOT_INITING):
            n_depth = int(jnp.sum((frame.depth > 0).astype(jnp.int32)))
            if n_depth < self.cfg.tracking.min_init_depth_kps:
                self.state = TrackState.NOT_INITING
                return None, {"init_depth_kps": n_depth}
            Tcw = jnp.eye(4, dtype=jnp.float32)
            pw, has = self._unproject(self.cam, frame, Tcw)
            self.last = TrackedFrame(frame=frame, Tcw=Tcw, pw=pw, has_pw=has)
            self.state = TrackState.OK
            return np.asarray(Tcw), {"initialized": True, "init_depth_kps": n_depth}

        Tcw, n_m, n_in, m, inlier = self._step(self.cam, frame, self.last, self.velocity)
        n_m, n_in = int(n_m), int(n_in)
        if n_m < self.min_matches:
            Tcw, n_m, n_in, m, inlier = self._step_wide(self.cam, frame, self.last, self.velocity)
            n_m, n_in = int(n_m), int(n_in)
            info["wide_retry"] = True
        info.update(n_matches=n_m, n_inliers=n_in)

        if n_in < self.min_inliers:
            self.state = TrackState.LOST
            return None, info

        self.velocity = Tcw @ se3.inverse(self.last.Tcw)
        pw, has = self._unproject(self.cam, frame, Tcw)
        self.last = TrackedFrame(frame=frame, Tcw=Tcw, pw=pw, has_pw=has)
        self.state = TrackState.OK
        return np.asarray(Tcw), info
