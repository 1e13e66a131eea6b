"""Image pyramid construction.

The reference builds an 8-level ×1.2 pyramid with a Gaussian-blurred copy of
every level for BRIEF sampling (reference: src/ORBExtractor.cc:278-320, blur
kernel 7×7 σ=2 at ORBExtractor.cc:311-318).  Here the pyramid is a tuple of
statically-shaped arrays produced by XLA resize + separable convolution —
one fused jit program, no per-level host loop at runtime.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    """Static per-level (H, W), mirroring cv::resize rounding (ORBExtractor.cc:287)."""
    out = []
    for l in range(n_levels):
        inv = 1.0 / (scale_factor ** l)
        out.append((int(round(h * inv)), int(round(w * inv))))
    return out


def _gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable 2-pass Gaussian blur with edge replication, [H, W] f32."""
    k = jnp.asarray(_gaussian_kernel_1d(ksize, sigma))
    pad = ksize // 2
    x = jnp.pad(img, ((pad, pad), (0, 0)), mode="edge")
    x = jax.lax.conv_general_dilated(
        x[None, None], k[None, None, :, None], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]
    x = jnp.pad(x, ((0, 0), (pad, pad)), mode="edge")
    x = jax.lax.conv_general_dilated(
        x[None, None], k[None, None, None, :], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]
    return x


@lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32 bilinear resampling matrix with half-pixel centres
    (the jax.image.resize / cv::resize INTER_LINEAR convention): output pixel
    i samples input coordinate (i + 0.5)·n_in/n_out − 0.5."""
    scale = n_in / n_out
    x = (np.arange(n_out) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = (x - x0).astype(np.float32)
    lo = np.clip(x0, 0, n_in - 1)
    hi = np.clip(x0 + 1, 0, n_in - 1)
    W = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(W, (rows, lo), 1.0 - frac)
    np.add.at(W, (rows, hi), frac)
    return W


def resize_bilinear_matmul(img: jnp.ndarray, h_out: int, w_out: int) -> jnp.ndarray:
    """Bilinear resize of [..., H, W] via two weight-matrix matmuls.

    Two small matmuls per level replace jax.image.resize's gathers and
    batch over leading dims (both stereo images resize in one einsum).
    """
    h_in, w_in = img.shape[-2:]
    Wh = jnp.asarray(_resize_weights(h_in, h_out)).astype(img.dtype)
    Ww = jnp.asarray(_resize_weights(w_in, w_out)).astype(img.dtype)
    tmp = jnp.einsum("hH,...HW->...hW", Wh, img, preferred_element_type=jnp.float32)
    out = jnp.einsum("...hW,wW->...hw", tmp.astype(img.dtype), Ww,
                     preferred_element_type=jnp.float32)
    return out.astype(img.dtype)


@lru_cache(maxsize=None)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] f32 box-average (cv INTER_AREA) resampling matrix:
    output pixel i averages the input span [i·s, (i+1)·s), s = n_in/n_out.
    Anti-aliased at any downscale factor, so every pyramid level can resize
    DIRECTLY from level 0 (plain bilinear would alias below scale 0.5)."""
    s = n_in / n_out
    W = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        lo, hi = i * s, (i + 1) * s
        j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
        for j in range(j0, min(j1, n_in)):
            W[i, j] = (min(j + 1.0, hi) - max(float(j), lo)) / s
    return W


@lru_cache(maxsize=None)
def _pyramid_block_weights(h: int, w: int, n_levels: int, scale_factor: float):
    """Resize operators for the shared-column pyramid: ``Ww_all [w, ΣWl]``
    (levels 1.. stacked along columns) for ONE shared column resize, and the
    per-level row operators ``Wh_l [Hl, h]``, plus column offsets."""
    shapes = level_shapes(h, w, n_levels, scale_factor)[1:]
    Ww_all = np.concatenate([_area_weights(w, wl).T for _, wl in shapes], axis=1)
    Wh_per = tuple(_area_weights(h, hl) for hl, _ in shapes)
    w_off = np.cumsum([0] + [wl for _, wl in shapes])
    return Wh_per, Ww_all, tuple(w_off.tolist())


@partial(jax.jit, static_argnames=("n_levels", "scale_factor"))
def build_pyramid(img: jnp.ndarray, n_levels: int = 8, scale_factor: float = 1.2):
    """[..., H, W] f32 → tuple of [..., Hl, Wl] levels (leading dims batch —
    a stereo pair's two images resize in the same matmuls).

    Formulation: every level resizes DIRECTLY from level 0 — ONE shared
    column resize ``img @ Ww_all`` (narrow axis H first keeps it cheap), then
    a per-level row matmul on that level's column slice.  The row matmuls
    all depend only on the shared product (no successive chain), and unlike
    the r3 one-shot [ΣH,W]×[W,ΣW] form there are NO off-diagonal
    level-row × level-col blocks (~85% of that product was discarded
    work: ~11 G vs ~2 G MACs/image at KITTI size).
    INTER_AREA box weights keep every scale anti-aliased; the reference's
    successive INTER_LINEAR chain (ORBExtractor.cc:287) accumulates a similar
    low-pass, so FAST/BRIEF see equivalent content (documented deviation).

    Unlike the reference there is NO per-level Gaussian-blurred copy
    (ORBExtractor.cc:311-318): BRIEF folds its blur into the descriptor
    sampling matrix (ops.brief._pair_difference_matrix) — a whole-level blur
    would compute values never read outside keypoint neighbourhoods.
    """
    h, w = img.shape[-2:]
    # bf16 image plane: halves the memory traffic of every image-space op (FAST's 16
    # rolled copies, canvas, patch gathers).  Intensities ≤255 carry ~0.5 grey
    # levels of rounding — far below FAST thresholds and BRIEF noise floors;
    # stages needing accumulation precision (SAD, moments) upcast locally.
    x = img.astype(jnp.bfloat16)
    if n_levels == 1:
        return (x,)
    Wh_per, Ww_np, w_off = _pyramid_block_weights(h, w, n_levels, scale_factor)
    Ww = jnp.asarray(Ww_np).astype(jnp.bfloat16)
    cols = jnp.einsum("...HW,Wc->...Hc", x, Ww,
                      preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [x]
    for l in range(1, n_levels):
        hl, wl = shapes[l]
        c0 = w_off[l - 1]
        col_l = jax.lax.slice_in_dim(cols, c0, c0 + wl, axis=-1)
        Wh = jnp.asarray(Wh_per[l - 1]).astype(jnp.bfloat16)
        levels.append(
            jnp.einsum("hH,...Hw->...hw", Wh, col_l,
                       preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        )
    return tuple(levels)
