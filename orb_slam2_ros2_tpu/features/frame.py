"""Frame data model: fixed-capacity struct-of-arrays pytrees.

The reference's ``VirtualFrame``/``Frame`` is a mutex-guarded class holding
STL vectors of keypoints, descriptors, stereo depths and map-point pointers
(reference: include/ORB_SLAM2/Frame.h:22-331, src/Frame.cc).  The data
model here is a padded SoA pytree with a validity mask — no pointers, no locks,
statically shaped for jit.  The reference's 48×64 grid index
(Frame.cc:52-69) has no equivalent here: area searches are dense masked
distance checks over all keypoint slots, which at these sizes (N ≤ 2048) is
one fused array op where a bucketed gather would be many small ones.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class FrameFeatures(NamedTuple):
    """One image's extracted features, padded to a static capacity N.

    ``uv`` are level-0 *undistorted* pixel coords (the reference undistorts
    all keypoints at frame construction, Frame.cc:106); ``uv_raw`` keeps the
    detector coords for patch sampling on the raw pyramid.
    """

    uv: jnp.ndarray        # f32[N, 2]
    uv_raw: jnp.ndarray    # f32[N, 2]
    octave: jnp.ndarray    # i32[N]
    response: jnp.ndarray  # f32[N]
    angle: jnp.ndarray     # f32[N] degrees [0, 360)
    desc: jnp.ndarray      # uint32[N, 8]
    valid: jnp.ndarray     # bool[N]

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


class StereoFrame(NamedTuple):
    """A stereo (or RGB-D) frame: left features + per-keypoint stereo depth.

    ``right_u`` is the matched right-image u coordinate (−1 when unmatched),
    ``depth`` = bf / disparity (−1 when unmatched) — the reference's
    ``mvFeatsRightU`` / ``mvDepths`` (Frame.h:345-349).  RGB-D frames fill
    both from the depth map with synthetic right_u = u − bf/d
    (reference Frame.cc:125-159).
    """

    feats: FrameFeatures
    right_u: jnp.ndarray   # f32[N]
    depth: jnp.ndarray     # f32[N]
