"""Oriented-BRIEF description: grey-centroid orientation + rotated point pairs.

The reference computes per-keypoint orientation from circular-patch image
moments and rotates a 256-pair template by exactly that angle before
comparing blurred intensities into a 32-byte descriptor (reference:
src/ORBExtractor.cc:465-487 ``getGrayCentroid``, :427-456 ``computeBRIEF``,
:242-267 template load from config/brief_template.txt).

Design differences:
- all keypoints are described in one batched program over the pyramid canvas;
- the rotation is discretized to ``N_ANGLE_BINS`` precomputed integer offset
  tables (a static LUT), so sampling is a pure gather with no per-keypoint
  trigonometry on the sampling path;
- the 256-pair template is generated once from a seeded Gaussian
  (σ = patch/5, the BRIEF recipe) rather than loaded from the reference's
  text file — the pipeline is self-consistent, descriptors never need to
  match the reference bit-for-bit;
- bits are packed to uint32[8] so hamming distance is XOR + popcount.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

N_PAIRS = 256
N_ANGLE_BINS = 32
# Patch geometry is the 48×64 window of ops.patches: centre at (22, 22)
# covers the rotated template reach (<19) plus the 3-px blur apron; one
# window per keypoint serves orientation, blurring and sampling.
from .patches import CENTER as PATCH_CENTER  # noqa: E402
from .patches import PATCH_COLS, PATCH_ROWS  # noqa: E402

PATCH_HALF = PATCH_CENTER  # keypoint border requirement (rows above/left)
TEMPLATE_CLIP = 13       # max |coordinate| of a template point pre-rotation
ORIENT_RADIUS = 15       # grey-centroid circular patch radius (ORBExtractor.cc:518)
BLUR_PAD = 3             # 7-tap Gaussian apron


_TEMPLATE_OVERRIDE = None  # set by set_template_file()


def load_template_file(path: str) -> np.ndarray:
    """Parse a BRIEF point-pair template in the reference's
    ``brief_template.txt`` format — a ``x1 y1 x2 y2`` header followed by one
    whitespace-separated pair per line (reference ORBExtractor.cc:242-267).
    Returns int32 [256, 4]; short files pad with (0,0,0,0) — a short file
    yields constant-0 trailing bits in the reference too."""
    import os

    if not os.path.exists(path):
        from ..errors import FileNotOpenError

        raise FileNotOpenError(f"BRIEF template file not found: {path}")
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            try:
                rows.append([float(v) for v in parts[:4]])
            except ValueError:
                continue  # header line
    if not rows:
        raise ValueError(f"BRIEF template file {path!r} contains no point pairs")
    t = np.round(np.asarray(rows))
    if np.abs(t).max() > TEMPLATE_CLIP:
        # rotated reach beyond the patch apron would sample outside the patch
        raise ValueError(
            f"template reach {np.abs(t).max():.0f} exceeds the supported "
            f"±{TEMPLATE_CLIP} (45×45 patch budget)"
        )
    t = t.astype(np.int32)
    if t.shape[0] < N_PAIRS:
        t = np.concatenate([t, np.zeros((N_PAIRS - t.shape[0], 4), np.int32)])
    return t[:N_PAIRS]


def set_template_file(path: str) -> None:
    """Make a file-loaded template the process-wide DEFAULT (used by
    ``describe`` calls that don't pass an explicit ``pair_matrix``).  The
    extractor factories instead bind their template per-instance via
    ``pair_matrix_for_template`` — prefer that; this global exists for tests
    and simple scripts."""
    global _TEMPLATE_OVERRIDE
    _TEMPLATE_OVERRIDE = load_template_file(path)
    brief_template.cache_clear()
    rotated_offset_lut.cache_clear()
    _pair_difference_matrix.cache_clear()


def clear_template_override() -> None:
    global _TEMPLATE_OVERRIDE
    _TEMPLATE_OVERRIDE = None
    brief_template.cache_clear()
    rotated_offset_lut.cache_clear()
    _pair_difference_matrix.cache_clear()


@lru_cache(maxsize=None)
def brief_template(seed: int = 17) -> np.ndarray:
    """[256, 4] int32 (x1, y1, x2, y2): seeded Gaussian pairs, BRIEF-style
    (or the file-loaded override, see ``set_template_file``)."""
    if _TEMPLATE_OVERRIDE is not None:
        return _TEMPLATE_OVERRIDE
    r = np.random.default_rng(seed)
    t = r.normal(scale=TEMPLATE_CLIP / 2.0, size=(N_PAIRS, 4))
    return np.clip(np.round(t), -TEMPLATE_CLIP, TEMPLATE_CLIP).astype(np.int32)


@lru_cache(maxsize=None)
def rotated_offset_lut(seed: int = 17) -> np.ndarray:
    """[N_ANGLE_BINS, 512] int32 flat indices into a 48×64 patch.

    Row b holds the template rotated by θ_b = 2πb/N_ANGLE_BINS: first the 256
    first-points, then the 256 second-points, each as y*PATCH_COLS + x
    relative to the patch corner (reference rotates per-keypoint with floats,
    ORBExtractor.cc:427-456; here rotation is a compile-time table).
    """
    return _lut_from_template(brief_template(seed))


def _lut_from_template(tpl: np.ndarray) -> np.ndarray:
    tpl = tpl.astype(np.float64)
    out = np.zeros((N_ANGLE_BINS, 2 * N_PAIRS), np.int32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for half, sl in ((tpl[:, 0:2], slice(0, N_PAIRS)), (tpl[:, 2:4], slice(N_PAIRS, 2 * N_PAIRS))):
            x, y = half[:, 0], half[:, 1]
            xr = np.round(c * x - s * y).astype(np.int32)
            yr = np.round(s * x + c * y).astype(np.int32)
            out[b, sl] = (yr + PATCH_CENTER) * PATCH_COLS + (xr + PATCH_CENTER)
    return out


@lru_cache(maxsize=None)
def _moment_weights():
    """Circular-mask coordinate weights for the grey-centroid over the
    48×64 patch (centre at (22, 22)), flattened."""
    ys, xs = np.mgrid[0:PATCH_ROWS, 0:PATCH_COLS]
    ys = ys - PATCH_CENTER
    xs = xs - PATCH_CENTER
    mask = (xs * xs + ys * ys) <= ORIENT_RADIUS * ORIENT_RADIUS
    wx = (xs * mask).astype(np.float32).reshape(-1)
    wy = (ys * mask).astype(np.float32).reshape(-1)
    return wx, wy


def orientations(patches: jnp.ndarray) -> jnp.ndarray:
    """Grey-centroid angle (radians, [-π, π]) per patch [N, P, P]
    (reference getGrayCentroid: θ = atan2(m01, m10), ORBExtractor.cc:465-487)."""
    wx, wy = _moment_weights()
    flat = patches.reshape(patches.shape[0], -1)
    w = jnp.stack([jnp.asarray(wx), jnp.asarray(wy)], axis=1).astype(flat.dtype)
    m = jnp.dot(flat, w, preferred_element_type=jnp.float32)  # [N, 2]
    return jnp.arctan2(m[:, 1], m[:, 0])


def blur_patches(patches: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian over patch stacks [N, P, P] as shifted weighted sums.

    Only the extracted patches are blurred (~60 MFLOP of elementwise adds),
    never whole pyramid levels, whose pixels away from keypoints are never
    sampled.  Patch borders use edge padding —
    only the ±3 px apron differs from a full-image blur and the sampling
    template never reaches it (PATCH_HALF covers reach + apron).
    """
    from .pyramid import _gaussian_kernel_1d

    # python-float taps keep weak typing so bf16 patches stay bf16
    k = [float(v) for v in _gaussian_kernel_1d(ksize, sigma)]
    pad = ksize // 2

    x = jnp.pad(patches, ((0, 0), (pad, pad), (0, 0)), mode="edge")
    x = sum(k[i] * x[:, i : i + patches.shape[1], :] for i in range(ksize))
    x = jnp.pad(x, ((0, 0), (0, 0), (pad, pad)), mode="edge")
    x = sum(k[i] * x[:, :, i : i + patches.shape[2]] for i in range(ksize))
    return x


@lru_cache(maxsize=None)
def _pair_difference_matrix(seed: int = 17):
    """[patch_px, N_ANGLE_BINS·N_PAIRS] f32: the oriented-BRIEF sampling
    pattern WITH the pre-compare Gaussian blur folded in.

    The reference blurs the image then samples single pixels
    (ORBExtractor.cc:427-456).  Blur is linear, so
    ``blur(patch)·(e_{p2} − e_{p1}) == patch·(g_{p2} − g_{p1})`` where g_p is
    the 7×7 Gaussian stamped at p — each column holds +G7 at the pair's
    second point and −G7 at its first.  Folding the blur here deletes the
    separate 2.8 ms/frame blur pass; template reach (≤19) + apron (3) stays
    inside the 48×64 patch, so edge handling never differs."""
    return _pair_matrix_from_lut(rotated_offset_lut(seed))


_PAIR_MATRIX_CACHE: dict = {}


def pair_matrix_for_template(tpl: np.ndarray) -> np.ndarray:
    """Folded-blur sampling matrix for an EXPLICIT template array — bound
    per extractor instance by the frontend factories, so two SLAM instances
    with different templates in one process never share state (the
    module-global ``set_template_file`` default cannot guarantee that under
    lazy jit tracing)."""
    key = tpl.tobytes()
    if key not in _PAIR_MATRIX_CACHE:
        _PAIR_MATRIX_CACHE[key] = _pair_matrix_from_lut(_lut_from_template(tpl))
    return _PAIR_MATRIX_CACHE[key]


def _pair_matrix_from_lut(lut: np.ndarray) -> np.ndarray:
    import numpy as _np

    from .pyramid import _gaussian_kernel_1d

    P = PATCH_ROWS * PATCH_COLS
    k1 = _gaussian_kernel_1d(7, 2.0).astype(_np.float64)
    g7 = _np.outer(k1, k1)  # [7, 7]
    D = _np.zeros((P, N_ANGLE_BINS * N_PAIRS), _np.float32)

    def stamp(col, flat_idx, sign):
        y, x = divmod(int(flat_idx), PATCH_COLS)
        D[
            (_np.arange(y - 3, y + 4)[:, None] * PATCH_COLS
             + _np.arange(x - 3, x + 4)[None, :]).reshape(-1),
            col,
        ] += sign * g7.reshape(-1)

    for b in range(N_ANGLE_BINS):
        for i in range(N_PAIRS):
            stamp(b * N_PAIRS + i, lut[b, i], -1.0)
            stamp(b * N_PAIRS + i, lut[b, N_PAIRS + i], +1.0)
    return D


def describe(
    patches: jnp.ndarray,
    angles: jnp.ndarray,
    seed: int = 17,
    pair_matrix: np.ndarray | None = None,
) -> jnp.ndarray:
    """BRIEF descriptors uint32[N, 8] from RAW patches [N, P, P] + angles.

    bit i = I_blur(rot(p1_i)) < I_blur(rot(p2_i)), packed little-endian into
    8 words — the reference's 32-byte descriptor as 8 uint32 lanes.

    Matmul formulation (gather-free): bit i for bin b is the sign of
    patch · (g_{p2} − g_{p1}) (blur folded into the matrix), so ONE
    [N, px] @ [px, bins·256] matmul computes every bin's blurred comparisons
    and a one-hot einsum selects each keypoint's bin — no 10⁶-element
    gather and no blur pass.
    """
    n = patches.shape[0]
    flat = patches.reshape(n, -1).astype(jnp.bfloat16)
    # bf16 inputs, f32 accumulate: ±1 pair entries are exact, patch values
    # round to ~1 gray level — comparisons of near-equal intensities are
    # noise-dominated anyway, and the matmul runs 4-8× faster than f32
    D_np = pair_matrix if pair_matrix is not None else _pair_difference_matrix(seed)
    D = jnp.asarray(D_np).astype(jnp.bfloat16)
    scores = jnp.dot(flat, D, preferred_element_type=jnp.float32).reshape(
        n, N_ANGLE_BINS, N_PAIRS
    )

    two_pi = 2.0 * jnp.pi
    frac = jnp.mod(angles, two_pi) / two_pi
    bins = jnp.clip((frac * N_ANGLE_BINS + 0.5).astype(jnp.int32) % N_ANGLE_BINS, 0, N_ANGLE_BINS - 1)
    onehot = jax.nn.one_hot(bins, N_ANGLE_BINS, dtype=scores.dtype)
    sel = jnp.einsum("nbc,nb->nc", scores, onehot)         # [N, 256]
    bits = (sel > 0).astype(jnp.uint32)
    words = bits.reshape(n, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def angles_deg(angles_rad: jnp.ndarray) -> jnp.ndarray:
    """Angle in degrees [0, 360) — the unit the rotation-consistency histogram
    uses (reference ORBMatcher.cc:1013-1051)."""
    return jnp.mod(angles_rad * (180.0 / jnp.pi), 360.0)
