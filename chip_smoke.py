#!/usr/bin/env python
"""Smoke run of the SLAM main path on an NVIDIA GPU, at full width.

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --four-cards  # four cards: the multi-device paths only

One card:
  1. device: platform, kind, count, card name and power limit;
  2. kernel parity at real widths: FAST+NMS and patch gather against NumPy,
     the stereo frontend / local BA / pose-only LM against the same jitted
     code on this process's CPU device;
  3. the main path: 120 KITTI-size stereo frames through ``SLAM.track()``
     with keyframing, mapping, local BA, KF culling and loop detection;
  4. loop closure: Sim3 cascade, essential graph and global BA on a circle;
  5. the CLI entry point, ``cli.main(["synth", "--frames", "40", ...])``.

Four cards: landmark-sharded global BA (4-card mesh vs 1-card mesh), the
edge-sharded essential graph (4-card mesh vs none), and the tracker/mapper
device split (vs one device).

Every phase prints one line: its result, its wall time and the numbers it
checked.  A failed check raises and the script exits non-zero; the last line,
a JSON object with ``"ok": true``, is printed only when every phase passed.
The script refuses to run without a GPU.  It is one JAX process and starts
no other (``nvidia-smi`` aside).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()


class Phase:
    """One phase's line: its checks are collected, then printed with the
    phase's wall time and the numbers it checked; any failed check raises."""

    def __init__(self, name: str):
        self.name, self.t0, self.failed = name, time.time(), []

    def check(self, cond, what: str) -> bool:
        if not cond:
            self.failed.append(what)
        return bool(cond)

    def done(self, **numbers) -> None:
        status = "ok" if not self.failed else "FAILED (" + "; ".join(self.failed) + ")"
        print(f"[{self.name}] {status} {time.time() - self.t0:.1f}s "
              f"{json.dumps(numbers, default=float)}", flush=True)
        if self.failed:
            raise AssertionError(f"phase {self.name}: " + "; ".join(self.failed))


def _rot_trans_diff(Ta, Tb):
    """Largest rotation difference (rad) and translation distance between two
    stacks of 4×4 poses.  ‖Ra − Rb‖_F/√2 equals the angle between them to
    first order, without the ~3e-4 rad floor arccos has on f32 rotations."""
    import numpy as np

    Ta, Tb = np.asarray(Ta, np.float64).reshape(-1, 4, 4), np.asarray(Tb, np.float64).reshape(-1, 4, 4)
    dr = np.linalg.norm(Ta[:, :3, :3] - Tb[:, :3, :3], axis=(1, 2)) / np.sqrt(2.0)
    return float(dr.max()), float(np.linalg.norm(Ta[:, :3, 3] - Tb[:, :3, 3], axis=1).max())


def _world(cam_cfg, n_frames, **kw):
    from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset

    return SyntheticStereoDataset(cam_cfg, n_frames=n_frames, **kw)


def _kitti_cfg():
    """Default SLAMConfig at ThDepth 60, as bench_full.py runs it."""
    from orb_slam2_ros2_tpu.config import SLAMConfig

    cfg = SLAMConfig()
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, th_depth=60.0))


# --------------------------------------------------------------------------
# phase 2: kernel parity
# --------------------------------------------------------------------------
def phase_kernels(cpu, cfg) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from orb_slam2_ros2_tpu.features import extractor
    from orb_slam2_ros2_tpu.geometry import se3
    from orb_slam2_ros2_tpu.geometry.camera import CameraParams
    from orb_slam2_ros2_tpu.ops import fast, reference_np
    from orb_slam2_ros2_tpu.ops.patches import extract_patches
    from orb_slam2_ros2_tpu.ops.pyramid import build_pyramid
    from orb_slam2_ros2_tpu.solvers.pose_opt import PoseObs, optimize_pose
    from orb_slam2_ros2_tpu.solvers.schur_ba import solve_ba_points

    sys.path.insert(0, ROOT)
    from bench import local_ba_problem

    if jax.config.jax_default_matmul_precision != "highest":
        raise AssertionError("the package must set matmul precision 'highest'")
    c, o = cfg.camera, cfg.orb
    il, ir, _ = _world(c, 2, speed=0.8, box_scale=2.5, sky=True).frame(0)
    imgs = jnp.stack([il, ir])

    # FAST score + 3x3 NMS, all 8 levels of a 1241x376 stereo pair.  Exact:
    # subtract/min/max on the level image, no matmul, no reduction order.
    ph = Phase("2a fast+nms")
    levels = jax.jit(lambda x: build_pyramid(x, o.n_levels, o.scale_factor))(imgs)
    th = float(o.min_th_fast)
    got = jax.jit(lambda lv: [fast.nms3(fast.fast_score(l, th)) for l in lv])(levels)
    m = 5  # ring radius 3 + NMS radius 1 + 1: the shipped map wraps there
    n_px = n_bad = 0
    for lv, g in zip(levels, got):
        lv, g = np.asarray(lv), np.asarray(g, np.float32)
        for b in range(lv.shape[0]):
            want = reference_np.nms3_np(reference_np.fast_score_np(lv[b], th))
            n_bad += int((g[b, m:-m, m:-m] != want[m:-m, m:-m]).sum())
            n_px += want[m:-m, m:-m].size
    ph.check(n_bad == 0, f"FAST+NMS differs from NumPy at {n_bad} pixels")
    ph.done(levels=len(levels), pixels=n_px, mismatches=n_bad, tolerance="bit-exact")

    # patch gather: the frame's 2 x max_keypoints centres on the real
    # row-stacked canvas, plus its four corners (clamped windows).
    ph = Phase("2b patches")
    caps = tuple(extractor.level_capacities(o.max_keypoints, o.n_levels, o.scale_factor))
    cam = CameraParams.from_config(c)
    kw = dict(h=c.height, w=c.width, n_levels=o.n_levels, scale_factor=o.scale_factor,
              caps=caps, border=o.edge_border, min_th=th, ini_th=float(o.ini_th_fast),
              cell=o.cell_size, undistort=False)
    feats, _ = jax.jit(lambda x: extractor.extract_features_batch(x, cam, **kw))(imgs)
    canvas = jax.jit(lambda lv: extractor.pyramid_canvas(lv, c.height, c.width, o.scale_factor))(levels)
    centres = extractor.keypoint_centers(feats.uv_raw, feats.octave, c.height, c.width,
                                         o.n_levels, o.scale_factor)
    hc, wc = canvas.shape
    corners = jnp.asarray([[0, 0], [0, wc - 1], [hc - 1, 0], [hc - 1, wc - 1]], jnp.int32)
    centres = jnp.concatenate([centres, corners])
    got = np.asarray(jax.jit(extract_patches)(canvas, centres))
    want = reference_np.patches_np(np.asarray(canvas), np.asarray(centres))
    n_bad = int((got != want).any(axis=(1, 2)).sum())
    ph.check(n_bad == 0, f"{n_bad} patches differ from NumPy slicing")
    ph.done(windows=int(centres.shape[0]), canvas=[hc, wc], mismatches=n_bad,
            tolerance="bit-exact")

    # whole stereo frontend, GPU against this process's CPU device.  Not
    # exact: the pyramid resize and BRIEF sampling are f32-accumulated
    # matmuls, summed in another order by cuBLAS than by the CPU, so last-bit
    # differences can flip FAST ties and descriptor comparisons.
    ph = Phase("2c frontend gpu~cpu")
    fe = extractor.make_stereo_frontend(cfg)
    sg = fe(il, ir, cam)
    sc = fe(*jax.device_put((il, ir, cam), cpu))

    def keyed(sf):
        v = np.asarray(sf.feats.valid)
        uv = np.asarray(sf.feats.uv_raw)[v]
        octv = np.asarray(sf.feats.octave)[v]
        d = np.asarray(sf.feats.desc)[v]
        return {(float(a), float(b), int(l)): dd.tobytes() for (a, b), l, dd in zip(uv, octv, d)}

    kg, kc = keyed(sg), keyed(sc)
    same = kg.keys() & kc.keys()
    pos_share = len(same) / max(len(kg.keys() | kc.keys()), 1)
    desc_share = sum(kg[k] == kc[k] for k in same) / max(len(same), 1)
    ph.check(pos_share >= 0.97, f"only {pos_share:.4f} of keypoints at identical positions")
    ph.check(desc_share >= 0.95, f"only {desc_share:.4f} of descriptors bit-identical")
    ph.done(keypoints_gpu=len(kg), keypoints_cpu=len(kc),
            same_position_share=round(pos_share, 5), same_descriptor_share=round(desc_share, 5),
            tolerance={"same_position_share": ">=0.97", "same_descriptor_share": ">=0.95"})

    # local BA: the production window of bench.py.  f32 normal equations over
    # 4096x24 edges summed in another order; LM accept/reject stays the same.
    ph = Phase("2d local BA gpu~cpu")
    bcam, prob = local_ba_problem()
    ba = jax.jit(lambda cm, p: solve_ba_points(cm, p, phase_iters=(2, 3))[:2])
    Tg, Pg = ba(bcam, prob)
    Tc, Pc = ba(*jax.device_put((bcam, prob), cpu))
    dr, dt = _rot_trans_diff(Tg, Tc)
    dp = float(np.abs(np.asarray(Pg) - np.asarray(Pc)).max())
    ph.check(dr < 1e-3 and dt < 1e-2, f"local BA GPU vs CPU: {dr:.2e} rad, {dt:.2e} m")
    ph.done(cameras=int(Tg.shape[0]), points=int(Pg.shape[0]), max_rot_rad=dr,
            max_trans_m=dt, max_point_m=dp, tolerance={"rot_rad": 1e-3, "trans_m": 1e-2})

    # pose-only LM on one free camera's observations of the same problem
    ph = Phase("2e pose LM gpu~cpu")
    k = 6
    ok = np.asarray(prob.obs_valid) & (np.asarray(prob.obs_cam) == k)
    p_idx, o_idx = np.nonzero(ok)
    M = 4096
    pad = lambda a, v=0: np.concatenate([a, np.full((M - len(a),) + a.shape[1:], v, a.dtype)])  # noqa: E731
    obs = PoseObs(
        pw=jnp.asarray(pad(np.asarray(prob.pt_pos)[p_idx])),
        uv=jnp.asarray(pad(np.asarray(prob.obs_uv)[p_idx, o_idx])),
        right_u=jnp.full((M,), -1.0, jnp.float32),
        inv_sigma2=jnp.ones((M,), jnp.float32),
        is_stereo=jnp.zeros((M,), bool),
        valid=jnp.asarray(pad(np.ones(len(p_idx), bool), False)),
    )
    T0k = se3.exp(jnp.asarray([0.05, -0.03, 0.08, 0.01, -0.008, 0.005], jnp.float32)) @ prob.cam_Tcw[k]
    po = jax.jit(lambda cm, T, ob: optimize_pose(cm, T, ob, rounds=cfg.ba.pose_rounds,
                                                 iters_per_round=cfg.ba.pose_iters_per_round))
    rg, rc = po(bcam, T0k, obs), po(*jax.device_put((bcam, T0k, obs), cpu))
    dr, dt = _rot_trans_diff(rg[0], rc[0])
    ph.check(dr < 5e-4 and dt < 5e-3, f"pose LM GPU vs CPU: {dr:.2e} rad, {dt:.2e} m")
    ph.check(int(rg[2]) == int(rc[2]), f"pose LM inliers GPU {int(rg[2])} vs CPU {int(rc[2])}")
    ph.done(observations=len(p_idx), inliers=int(rg[2]), rot_rad=dr, trans_m=dt,
            tolerance={"rot_rad": 5e-4, "trans_m": 5e-3})


# --------------------------------------------------------------------------
# phase 3: the main path at full width
# --------------------------------------------------------------------------
def _ate(pairs, gt):
    import numpy as np

    from orb_slam2_ros2_tpu.io.trajectory import ate_rmse

    est = [np.linalg.inv(T) for f, T in pairs if f in gt]
    return ate_rmse(est, [gt[f] for f, _ in pairs if f in gt])


def phase_main_path(cfg, n_frames: int, warm: int, n_return: int) -> None:
    """Live tracking and mapping through ``SLAM.track()``, then bench.py's
    return pass over the finished map, where its inlier floor applies."""
    import numpy as np

    from orb_slam2_ros2_tpu.pipeline.system import STAT_KEYS, SLAM

    sys.path.insert(0, ROOT)
    from bench import return_pass

    ph = Phase("3 main path")
    ds = _world(cfg.camera, n_frames + 2, speed=0.8, box_scale=2.5, sky=True)
    raw = [ds.frame(i) for i in range(n_frames)]
    gt = {i: np.asarray(g) for i, (_, _, g) in enumerate(raw)}
    slam = SLAM(cfg)
    live_inliers, lost = [], []
    t_track = time.time()
    for i, (il, ir, _) in enumerate(raw):
        Tcw, stats = slam.track(il, ir)
        if i == 0:
            first_s = time.time() - t_track
        if Tcw is None:
            lost.append(i)
        if "n_tracked" in stats:
            live_inliers.append(stats["n_tracked"])
    slam.flush()
    ph.check(not lost, f"frames not tracked: {lost}")
    kfs_inserted = slam._n_kf
    ph.check(kfs_inserted >= 10, f"only {kfs_inserted} keyframes inserted")
    ph.check(slam.loop_closer is not None, "loop detection never ran")
    fids = sorted(gt)
    path = float(sum(np.linalg.norm(gt[b][:3, 3] - gt[a][:3, 3]) for a, b in zip(fids, fids[1:])))
    ate_live, ate_final = _ate(slam.trajectory, gt), _ate(slam.final_trajectory(), gt)
    ph.check(ate_live < 0.05 * path, f"live ATE {ate_live:.3f} m on a {path:.1f} m path")
    ph.check(ate_final < 0.03 * path, f"final ATE {ate_final:.3f} m on a {path:.1f} m path")
    ft = np.asarray(slam.frame_times_ms[warm:])

    # bench.py's inlier floor, where bench.py takes it: the production frame
    # program tracking the return pass over the finished map
    run, args = return_pass(slam, [f[0] for f in raw], [f[1] for f in raw], n_return)
    hv = np.asarray(run(*args))
    ret = hv[:, STAT_KEYS.index("n_tracked")]
    ret_med = float(np.median(ret))
    ph.check(ret_med >= 300, f"return-pass median inliers {ret_med} < 300")
    ph.done(frames=n_frames, tracked=n_frames - len(lost), keyframes_inserted=kfs_inserted,
            keyframes=slam.n_keyframes, mappoints=slam.n_mappoints,
            ate_live_m=round(ate_live, 4), ate_final_m=round(ate_final, 4), path_m=round(path, 2),
            live_median_inliers=float(np.median(live_inliers)),
            return_pass_frames=n_return, return_pass_median_inliers=ret_med,
            return_pass_min_inliers=float(ret.min()),
            first_frame_s=round(first_s, 2), warm_frames=warm,
            frame_ms_p50=round(float(np.median(ft)), 3),
            frame_ms_p99=round(float(np.percentile(ft, 99)), 3))


# --------------------------------------------------------------------------
# phase 4: loop closure
# --------------------------------------------------------------------------
def loop_cfg():
    """The circle world's config of tests/test_loop_closing.py."""
    from orb_slam2_ros2_tpu.config import (
        BAConfig, BoWConfig, CameraConfig, MapConfig, ORBConfig, SLAMConfig, TrackingConfig,
    )

    return SLAMConfig(
        camera=CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                            width=320, height=192),
        orb=ORBConfig(n_features=600, max_keypoints=768),
        tracking=TrackingConfig(min_init_depth_kps=120, max_local_mappoints=4096,
                                max_local_keyframes=16, motion_search_radius=35.0,
                                min_localmap_matches=20, min_localmap_inliers=20,
                                min_frames=1),
        map=MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
        bow=BoWConfig(branching=6, depth=3),
        ba=BAConfig(pcg_iters=20),
    )


def phase_loop(n_frames: int = 56) -> None:
    import numpy as np

    from orb_slam2_ros2_tpu.io.trajectory import ate_rmse
    from orb_slam2_ros2_tpu.pipeline.system import SLAM

    ph = Phase("4 loop closure")
    cfg = loop_cfg()
    ds = _world(cfg.camera, n_frames, circle=True)
    slam = SLAM(cfg)
    est, gt = [], []
    for i in range(n_frames):
        il, ir, Twc = ds.frame(i)
        Tcw, stats = slam.track(il, ir)
        if not ph.check(Tcw is not None, f"lost at frame {i}: {stats}"):
            ph.done(frames=i)
        est.append(np.linalg.inv(Tcw))
        gt.append(np.asarray(Twc))
    circ = 2 * np.pi * 4.0
    ate = ate_rmse(est, gt)
    ph.check(ate < 0.07 * circ, f"live ATE {ate:.3f} over {circ:.1f} m")
    slam.flush()
    ph.check(slam.loops_closed >= 1, "no loop closed")
    ph.check(slam.global_bas_committed >= 1, "post-closure global BA never committed")
    fin = dict(slam.final_trajectory())
    est_f = [np.linalg.inv(fin[i]) for i in range(n_frames) if i in fin]
    if not ph.check(len(est_f) >= n_frames - 2, f"final trajectory has {len(est_f)} frames"):
        ph.done(frames=n_frames)
    rel_gt = (np.linalg.inv(gt[0]) @ gt[-1])[:3, 3]
    d_end = float(np.linalg.norm((np.linalg.inv(est_f[0]) @ est_f[-1])[:3, 3] - rel_gt))
    d_live = float(np.linalg.norm((np.linalg.inv(est[0]) @ est[-1])[:3, 3] - rel_gt))
    ate_f = ate_rmse(est_f, [gt[i] for i in range(n_frames) if i in fin])
    ph.check(d_end < 1.2, f"final endpoint error {d_end:.2f} m")
    ph.check(ate_f < 0.05 * circ, f"final ATE {ate_f:.3f}")
    ph.check(d_live < 2.5, f"live endpoint error {d_live:.2f} m")
    ph.done(frames=n_frames, loops_closed=slam.loops_closed,
            global_bas_committed=slam.global_bas_committed, keyframes=slam.n_keyframes,
            ate_live_m=round(ate, 4), ate_final_m=round(ate_f, 4),
            endpoint_final_m=round(d_end, 4), endpoint_live_m=round(d_live, 4))


# --------------------------------------------------------------------------
# phase 5: the CLI
# --------------------------------------------------------------------------
def phase_cli(n_frames: int = 40) -> None:
    import math

    from orb_slam2_ros2_tpu import cli

    ph = Phase("5 cli synth")
    out_dir = os.path.join(ROOT, "chiprun_out", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["synth", "--frames", str(n_frames), "--out", os.path.join(out_dir, "synth")])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    ph.check(res["frames"] == n_frames and res["tracked"] == n_frames, "CLI lost frames")
    ph.check(math.isfinite(res.get("ate_rmse", float("nan"))), "CLI printed no ATE")
    ph.check(os.path.getsize(os.path.join(out_dir, "synth.kitti.txt")) > 0, "no trajectory file")
    ph.done(**res)


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------
def phase_four_gba(n_dev: int) -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from orb_slam2_ros2_tpu.parallel.mesh import ba_mesh
    from orb_slam2_ros2_tpu.solvers.pcg_ba import solve_global_ba_sharded

    sys.path.insert(0, ROOT)
    from __graft_entry__ import gba_problem

    ph = Phase("4a sharded global BA")
    cam, prob = gba_problem(n_dev)
    run = lambda mesh: solve_global_ba_sharded(cam, prob, mesh, phase_iters=(1, 1), pcg_iters=8)  # noqa: E731
    res, ms = {}, {}
    for name, mesh in (("mesh_n", ba_mesh(n_dev)), ("mesh_1", Mesh(np.array(jax.devices()[:1]), ("ba",)))):
        jax.block_until_ready(run(mesh))
        t1 = time.perf_counter()
        res[name] = jax.block_until_ready(run(mesh))
        ms[name] = (time.perf_counter() - t1) * 1e3
    dr, dt = _rot_trans_diff(res["mesh_n"][0], res["mesh_1"][0])
    dp = float(np.abs(np.asarray(res["mesh_n"][1]) - np.asarray(res["mesh_1"][1])).max())
    # psum over shards changes the f32 reduction order of the camera system
    ph.check(dr < 1e-3 and dt < 1e-2 and dp < 5e-2,
             f"sharded GBA differs: {dr:.2e} rad, {dt:.2e} m, points {dp:.2e} m")
    ph.done(devices=n_dev, cameras=int(prob.cam_Tcw.shape[0]), points=int(prob.pt_pos.shape[0]),
            ms_mesh_n=round(ms["mesh_n"], 2), ms_mesh_1=round(ms["mesh_1"], 2),
            max_rot_rad=dr, max_trans_m=dt, max_point_m=dp,
            tolerance={"rot_rad": 1e-3, "trans_m": 1e-2, "point_m": 5e-2})


def phase_four_pose_graph(n_dev: int, K: int = 512) -> None:
    import jax
    import numpy as np

    from orb_slam2_ros2_tpu.parallel.mesh import ba_mesh
    from orb_slam2_ros2_tpu.solvers.pose_graph import optimize_pose_graph

    sys.path.insert(0, ROOT)
    from __graft_entry__ import pose_graph_problem

    ph = Phase("4b sharded pose graph")
    pg = pose_graph_problem(K)
    out, ms = {}, {}
    for name, mesh in (("mesh_n", ba_mesh(n_dev)), ("none", None)):
        run = lambda: optimize_pose_graph(pg, iters=5, cg_iters=60, mesh=mesh, mesh_axis="ba")  # noqa: E731
        jax.block_until_ready(run())
        t1 = time.perf_counter()
        out[name] = jax.block_until_ready(run())
        ms[name] = (time.perf_counter() - t1) * 1e3
    dR = float(np.abs(np.asarray(out["mesh_n"].R) - np.asarray(out["none"].R)).max())
    dt = float(np.abs(np.asarray(out["mesh_n"].t) - np.asarray(out["none"].t)).max())
    ds = float(np.abs(np.asarray(out["mesh_n"].s) - np.asarray(out["none"].s)).max())
    ph.check(dR < 1e-3 and dt < 1e-2 and ds < 1e-3,
             f"sharded pose graph differs: R {dR:.2e}, t {dt:.2e}, s {ds:.2e}")
    ph.done(devices=n_dev, vertices=K, ms_mesh_n=round(ms["mesh_n"], 2),
            ms_no_mesh=round(ms["none"], 2), max_R_entry=dR, max_t=dt, max_s=ds,
            tolerance={"R_entry": 1e-3, "t": 1e-2, "s": 1e-3})


def phase_four_split(cfg, n_frames: int = 40) -> None:
    import numpy as np

    from orb_slam2_ros2_tpu.pipeline.system import SLAM

    ph = Phase("4c tracker/mapper split")
    ds = _world(cfg.camera, n_frames, speed=0.8)
    raw = [ds.frame(i) for i in range(n_frames)]
    traj, devs = {}, ("", "")
    for name, split in (("split", True), ("single", False)):
        c = cfg.replace(dist=dataclasses.replace(cfg.dist, tracker_mapper_split=split))
        slam = SLAM(c, enable_loop_closing=False)
        poses = []
        for i, (il, ir, _) in enumerate(raw):
            Tcw, stats = slam.track(il, ir)
            if not ph.check(Tcw is not None, f"{name}: lost at frame {i}: {stats}"):
                ph.done(frames=i)
            poses.append(Tcw)
        slam.flush()
        if split:
            d_map = next(iter(slam.map.kf_Tcw.devices()))
            d_trk = next(iter(slam.last.Tcw.devices()))
            ph.check(d_map != d_trk, f"map and tracker share {d_map}")
            devs = (str(d_trk), str(d_map))
        traj[name] = np.stack(poses)
    dr, dt = _rot_trans_diff(traj["split"], traj["single"])
    ph.check(dr < 1e-2 and dt < 0.1, f"split trajectory differs: {dr:.2e} rad, {dt:.2e} m")
    ph.done(frames=n_frames, tracker_device=devs[0], map_device=devs[1],
            max_rot_rad=dr, max_trans_m=dt, tolerance={"rot_rad": 1e-2, "trans_m": 0.1})


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four cards")
    args = ap.parse_args(argv)

    # the parity phase compares against this process's CPU device
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    dev = jax.devices()[0]
    n_need = 4 if args.four_cards else 1
    if dev.platform != "gpu" or len(jax.devices()) < n_need:
        print(f"chip_smoke: needs {n_need} GPU(s); JAX found {jax.devices()}", file=sys.stderr)
        return 1

    sys.path.insert(0, ROOT)
    from orb_slam2_ros2_tpu.utils import setup_compile_cache

    from orb_slam2_ros2_tpu.config import SLAMConfig

    cache = setup_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"jax {jax.__version__}; compile cache {cache}", flush=True)
    Phase("1 device").done(platform=dev.platform, kind=dev.device_kind,
                           count=len(jax.devices()), nvidia_smi=smi.splitlines())

    if args.four_cards:
        phase_four_gba(4)
        phase_four_pose_graph(4)
        phase_four_split(SLAMConfig())
    else:
        phase_kernels(jax.devices("cpu")[0], _kitti_cfg())
        phase_main_path(_kitti_cfg(), n_frames=120, warm=40, n_return=80)
        phase_loop()
        phase_cli()

    peak = max(d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()[:n_need])
    print(f"peak_bytes_in_use {peak}; total {time.time() - T0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
