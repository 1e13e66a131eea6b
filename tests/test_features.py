"""Feature-engine tests: FAST, BRIEF, extractor, stereo depth."""

import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam2_ros2_tpu.config import CameraConfig, SLAMConfig, ORBConfig
from orb_slam2_ros2_tpu.features.extractor import (
    level_capacities,
    make_extractor,
    make_stereo_frontend,
)
from orb_slam2_ros2_tpu.geometry.camera import CameraParams
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset, render
from orb_slam2_ros2_tpu.ops import brief, fast
from orb_slam2_ros2_tpu.ops.hamming import hamming_matrix, hamming_pairs


# Small config for fast tests

import pytest

pytestmark = pytest.mark.smoke  # fast subset: `pytest -m smoke` < 60 s

def small_cfg(h=192, w=256, n_kp=512):
    return SLAMConfig(
        camera=CameraConfig(fx=160.0, fy=160.0, cx=w / 2, cy=h / 2, baseline=0.5,
                            width=w, height=h),
        orb=ORBConfig(n_features=500, max_keypoints=n_kp),
    )


def np_fast_score(img, threshold):
    """Brute-force FAST-9/16 reference in numpy (interior pixels only)."""
    offs = fast.CIRCLE_OFFSETS
    h, w = img.shape
    score = np.zeros((h, w), np.float32)
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            d = np.array([img[y + dy, x + dx] for dy, dx in offs]) - img[y, x]
            best = 0.0
            for s in range(16):
                arc = [d[(s + j) % 16] for j in range(9)]
                best = max(best, min(arc), min(-v for v in arc))
            if best > threshold:
                score[y, x] = best
    return score


class TestFAST:
    def test_score_matches_bruteforce(self):
        r = np.random.default_rng(0)
        img = (r.uniform(0, 255, (24, 24))).astype(np.float32)
        got = np.asarray(fast.fast_score(jnp.asarray(img), 20.0))
        want = np_fast_score(img, 20.0)
        np.testing.assert_allclose(got[4:-4, 4:-4], want[4:-4, 4:-4], atol=1e-3)

    def test_square_corners_detected(self):
        img = np.zeros((64, 64), np.float32)
        img[24:40, 24:40] = 255.0
        score = np.asarray(fast.nms3(fast.fast_score(jnp.asarray(img), 20.0)))
        ys, xs = np.nonzero(score)
        assert len(ys) >= 4
        # all detections near the 4 square corners
        corners = np.array([[24, 24], [24, 39], [39, 24], [39, 39]])
        for y, x in zip(ys, xs):
            assert np.min(np.abs(corners - [y, x]).sum(axis=1)) <= 4

    def test_select_respects_border_and_capacity(self):
        r = np.random.default_rng(1)
        img = (r.uniform(0, 255, (96, 128))).astype(np.float32)
        score = fast.nms3(fast.fast_score(jnp.asarray(img), 7.0))
        uv, resp, valid = fast.select_keypoints(score, 128, border=19)
        uv, valid = np.asarray(uv), np.asarray(valid)
        assert uv.shape == (128, 2)
        v = uv[valid]
        assert (v[:, 0] >= 19).all() and (v[:, 0] < 128 - 19).all()
        assert (v[:, 1] >= 19).all() and (v[:, 1] < 96 - 19).all()


class TestHamming:
    def test_matrix_vs_pairs(self):
        r = np.random.default_rng(2)
        a = r.integers(0, 2**32, (16, 8), dtype=np.uint32)
        b = r.integers(0, 2**32, (24, 8), dtype=np.uint32)
        M = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        for i in range(16):
            for j in range(0, 24, 5):
                want = bin(int.from_bytes(a[i].tobytes(), "little") ^ int.from_bytes(b[j].tobytes(), "little")).count("1")
                assert M[i, j] == want

    def test_zero_distance_to_self(self):
        r = np.random.default_rng(3)
        a = r.integers(0, 2**32, (8, 8), dtype=np.uint32)
        M = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(a)))
        np.testing.assert_array_equal(np.diag(M), 0)
        d = np.asarray(hamming_pairs(jnp.asarray(a), jnp.asarray(a)))
        np.testing.assert_array_equal(d, 0)


class TestBRIEF:
    def test_descriptor_determinism_and_locality(self):
        r = np.random.default_rng(4)
        patches = jnp.asarray(r.uniform(0, 255, (4, 48, 64)).astype(np.float32))
        angles = jnp.zeros((4,))
        d1 = brief.describe(patches, angles)
        d2 = brief.describe(patches, angles)
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
        # different patches → different descriptors
        M = np.asarray(hamming_matrix(d1, d1))
        off_diag = M[~np.eye(4, dtype=bool)]
        assert (off_diag > 60).all()

    def test_rotation_reduces_distance(self):
        """Rotating patch + matching angle bin ≈ same descriptor (approximate
        rotation invariance of oriented BRIEF)."""
        r = np.random.default_rng(5)
        base = r.uniform(0, 255, (112, 112)).astype(np.float32)
        # smooth it to make rotation resampling mild
        from scipy.ndimage import gaussian_filter, rotate

        base = gaussian_filter(base, 2.0)
        patch0 = base[56 - 22 : 56 + 26, 56 - 22 : 56 + 42]
        ang = 90.0
        rot = rotate(base, -ang, reshape=False, order=1)
        patch1 = rot[56 - 22 : 56 + 26, 56 - 22 : 56 + 42]
        d0 = brief.describe(jnp.asarray(patch0[None]), jnp.asarray([0.0]))
        d1_rot = brief.describe(jnp.asarray(patch1[None]), jnp.asarray([np.deg2rad(ang)]))
        d1_norot = brief.describe(jnp.asarray(patch1[None]), jnp.asarray([0.0]))
        dist_oriented = int(hamming_pairs(d0, d1_rot)[0])
        dist_plain = int(hamming_pairs(d0, d1_norot)[0])
        assert dist_oriented < dist_plain
        assert dist_oriented < 80


class TestExtractor:
    def test_extract_synthetic(self):
        cfg = small_cfg()
        ds = SyntheticStereoDataset(cfg.camera, n_frames=1)
        img, _, _ = ds.frame(0)
        ex = make_extractor(cfg)
        cam = CameraParams.from_config(cfg.camera)
        feats, canvas_raw = ex(img, cam)
        valid = np.asarray(feats.valid)
        assert valid.sum() > 200
        uv = np.asarray(feats.uv)[valid]
        assert (uv[:, 0] >= 0).all() and (uv[:, 0] < cfg.camera.width).all()
        octs = np.asarray(feats.octave)[valid]
        assert octs.min() == 0 and octs.max() <= 7
        # descriptors nontrivial
        desc = np.asarray(feats.desc)[valid]
        assert len(np.unique(desc, axis=0)) > len(desc) * 0.9

    def test_capacities(self):
        caps = level_capacities(2048, 8, 1.2)
        assert sum(caps) == 2048
        assert all(c > 0 for c in caps)
        assert caps[0] > caps[-1]


class TestStereoDepth:
    def test_stereo_depth_accuracy(self):
        cfg = small_cfg()
        ds = SyntheticStereoDataset(cfg.camera, n_frames=1)
        imgL, imgR, _ = ds.frame(0)
        _, depth_gt = render(ds.K_inv, jnp.asarray(ds.poses_wc[0]), cfg.camera.height, cfg.camera.width)
        fe = make_stereo_frontend(cfg)
        cam = CameraParams.from_config(cfg.camera)
        sf = fe(imgL, imgR, cam)
        depth = np.asarray(sf.depth)
        valid = depth > 0
        assert valid.sum() > 100, f"only {valid.sum()} stereo matches"
        uv = np.asarray(sf.feats.uv_raw)[valid]
        dgt = np.asarray(depth_gt)[
            np.clip(np.round(uv[:, 1]).astype(int), 0, cfg.camera.height - 1),
            np.clip(np.round(uv[:, 0]).astype(int), 0, cfg.camera.width - 1),
        ]
        rel = np.abs(depth[valid] - dgt) / dgt
        # majority of matched depths within 10% of ground truth
        assert np.median(rel) < 0.1, f"median rel depth err {np.median(rel):.3f}"


class TestBriefTemplateFile:
    @pytest.mark.smoke
    def test_reference_format_loads_and_changes_descriptors(self, tmp_path):
        """A reference-format brief_template.txt (header + 'x1 y1 x2 y2'
        rows, ORBExtractor.cc:242-267) must become the active template —
        descriptor-level compat with reference-built maps."""
        rng = np.random.default_rng(3)
        t = np.clip(np.round(rng.normal(0, 6, (255, 4))), -13, 13).astype(int)
        path = tmp_path / "tmpl.txt"
        path.write_text(
            "x1\ty1\tx2\ty2\n" + "\n".join("\t".join(map(str, r)) for r in t)
        )

        patches = jnp.asarray(
            rng.uniform(0, 255, (4, brief.PATCH_ROWS, brief.PATCH_COLS)).astype(np.float32)
        )
        angles = jnp.zeros((4,), jnp.float32)
        d_default = np.asarray(brief.describe(patches, angles))
        try:
            brief.set_template_file(str(path))
            loaded = brief.brief_template()
            assert loaded.shape == (256, 4)
            np.testing.assert_array_equal(loaded[:255], t)
            np.testing.assert_array_equal(loaded[255], 0)  # padded pair
            d_file = np.asarray(brief.describe(patches, angles))
        finally:
            brief.clear_template_override()
        assert (d_file != d_default).any(), "override did not change descriptors"
        # default template restored after clearing
        d_again = np.asarray(brief.describe(patches, angles))
        np.testing.assert_array_equal(d_again, d_default)

    @pytest.mark.smoke
    def test_oversized_reach_rejected(self, tmp_path):
        path = tmp_path / "bad.txt"
        path.write_text("x1 y1 x2 y2\n20 0 -20 0\n")
        with pytest.raises(ValueError, match="reach"):
            brief.set_template_file(str(path))
        brief.clear_template_override()


@pytest.mark.smoke
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(96, 200), (123, 321), (77, 130)])
def test_fast_score_matches_numpy_reference(shape, dtype):
    """The rolled-copy FAST formulation equals the brute-force NumPy
    FAST-9/16 bit for bit in the interior, in the image's own dtype (the
    pyramid is bf16).  Within 4 px of the edge the rolls wrap around; the
    keypoint border discards that band."""
    from orb_slam2_ros2_tpu.ops.reference_np import fast_score_np

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (2,) + shape).astype(np.float32)).astype(dtype)
    got = np.asarray(fast.fast_score(img, 7.0), np.float32)
    m = 4
    for b in range(2):
        want = fast_score_np(np.asarray(img[b]), 7.0)
        np.testing.assert_array_equal(got[b, m:-m, m:-m], want[m:-m, m:-m])


@pytest.mark.smoke
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_nms3_matches_numpy_reference(dtype):
    """3×3 NMS keeps exactly the pixels no smaller than any in-image
    neighbour — ties kept on both sides, image edges included."""
    from orb_slam2_ros2_tpu.ops.reference_np import nms3_np

    rng = np.random.default_rng(1)
    score = rng.integers(0, 4, (2, 37, 53)).astype(np.float32) * (rng.random((2, 37, 53)) < 0.5)
    got = np.asarray(fast.nms3(jnp.asarray(score).astype(dtype)), np.float32)
    for b in range(2):
        np.testing.assert_array_equal(got[b], nms3_np(score[b]))


@pytest.mark.smoke
def test_template_binds_per_instance(tmp_path):
    """A configured template must bind to ITS extractor only: a template-less
    instance created afterwards keeps the default descriptors (no module-
    global leakage across SLAM instances)."""
    import dataclasses

    rng = np.random.default_rng(9)
    t = np.clip(np.round(rng.normal(0, 6, (256, 4))), -13, 13).astype(int)
    path = tmp_path / "tmpl.txt"
    path.write_text("x1 y1 x2 y2\n" + "\n".join(" ".join(map(str, r)) for r in t))

    cfg_plain = small_cfg()
    cfg_tmpl = cfg_plain.replace(
        orb=dataclasses.replace(cfg_plain.orb, brief_template_path=str(path))
    )
    ds = SyntheticStereoDataset(cfg_plain.camera, n_frames=1)
    img, _, _ = ds.frame(0)
    cam = CameraParams.from_config(cfg_plain.camera)

    ex_tmpl = make_extractor(cfg_tmpl)
    f_tmpl, _ = ex_tmpl(img, cam)          # traces with the file template
    ex_plain = make_extractor(cfg_plain)
    f_plain, _ = ex_plain(img, cam)        # must NOT inherit the template

    ex_plain2 = make_extractor(small_cfg())
    f_plain2, _ = ex_plain2(img, cam)
    v = np.asarray(f_plain.valid) & np.asarray(f_plain2.valid) & np.asarray(f_tmpl.valid)
    np.testing.assert_array_equal(
        np.asarray(f_plain.desc)[v], np.asarray(f_plain2.desc)[v]
    )
    assert (np.asarray(f_tmpl.desc)[v] != np.asarray(f_plain.desc)[v]).any()
