"""Command-line drivers: the reference's example binaries as one CLI.

Replaces example/Stereo/KittiStereo.cc, example/RGB-D/TUMRGBD.cc (reference
L7) with::

    python -m orb_slam2_ros2_tpu.cli kitti --seq /path/to/00 --config cfg.yaml
    python -m orb_slam2_ros2_tpu.cli tum   --seq /path/to/fr2_desk
    python -m orb_slam2_ros2_tpu.cli synth --frames 200          # no dataset needed

Writes a KITTI-format trajectory (and TUM-format for tum/synth) plus a JSON
stats line; evaluates ATE when ground truth is available.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_cfg(args, width, height):
    from .config import SLAMConfig

    if args.config:
        cfg = SLAMConfig.from_yaml(args.config)
    else:
        cfg = SLAMConfig()
    cam = cfg.camera
    if (width, height) != (cam.width, cam.height):
        cfg = cfg.replace(camera=cam.__class__(**{**cam.__dict__, "width": width, "height": height}))
    if getattr(args, "pipelined", False):
        import dataclasses as _dc

        cfg = cfg.replace(tracking=_dc.replace(cfg.tracking, pipelined=True))
    if getattr(args, "distributed", False):
        from .parallel.mesh import init_distributed

        pid = init_distributed()
        print(f"[distributed] process {pid}", file=sys.stderr)
    if getattr(args, "ba_devices", 0) > 1:
        cfg = cfg.replace(dist=cfg.dist.__class__(n_devices=args.ba_devices,
                                                  mesh_axis=cfg.dist.mesh_axis))
    return cfg


def _align_pipelined(slam, poses, n):
    """Pipelined tracking returns poses one frame late — rebuild the
    per-frame pose list from the resolve-time trajectory records so the
    exported files stay frame-aligned."""
    if not slam.cfg.tracking.pipelined:
        return poses
    slam.flush()
    by_fid = {f: np.linalg.inv(T) for f, T in slam.trajectory}
    return [by_fid.get(i) for i in range(n)]


def _make_viewer(slam, args):
    if not getattr(args, "viewer", ""):
        return None
    from .viewer import LiveViewer

    return LiveViewer(slam, every=args.viewer_every, out_dir=args.viewer)


def run_stereo(dataset, cfg, args):
    import jax.numpy as jnp

    from .pipeline.system import SLAM

    slam = SLAM(cfg)
    if args.load_map:
        slam.load(args.load_map)
    viewer = _make_viewer(slam, args)
    poses, stamps = [], []
    t0 = time.time()
    n = min(len(dataset), args.frames) if args.frames else len(dataset)
    for i in range(n):
        left, right, stamp = dataset.frame(i)
        Tcw, stats = slam.track(jnp.asarray(left), jnp.asarray(right))
        poses.append(np.linalg.inv(Tcw) if Tcw is not None else None)
        stamps.append(stamp)
        if viewer is not None:
            viewer.update(Tcw)
        if i % 50 == 0:
            print(f"frame {i}/{n}: {stats}", file=sys.stderr)
    wall = time.time() - t0
    poses = _align_pipelined(slam, poses, n)
    if viewer is not None:
        viewer.close()
    return slam, poses, stamps, wall


def _train_vocab(args):
    """Offline vocabulary training (the reference ships DBoW3's pre-trained
    ORBvoc, System.cc:92-95; we train on extracted ORB descriptors — from a
    real sequence when given, else from diverse synthetic viewpoints)."""
    import jax
    import jax.numpy as jnp

    from .bow.vocabulary import save_vocabulary, train_vocabulary
    from .config import SLAMConfig
    from .features.extractor import make_stereo_frontend
    from .geometry.camera import CameraParams

    if args.seq:
        from .io.datasets import KittiStereoDataset

        ds = KittiStereoDataset(args.seq)
        h, w = ds.frame(0)[0].shape
        cfg = SLAMConfig().replace(camera=SLAMConfig().camera.__class__(width=w, height=h))
    else:
        from .io.synthetic import SyntheticStereoDataset

        cfg = SLAMConfig()
        # two trajectories through the box → distinct wall/floor viewpoints
        ds_fwd = SyntheticStereoDataset(cfg.camera, n_frames=args.frames, speed=1.6)
        ds_cir = SyntheticStereoDataset(cfg.camera, n_frames=args.frames, circle=True)

    cam = CameraParams.from_config(cfg.camera)
    frontend = jax.jit(make_stereo_frontend(cfg))
    descs = []
    n_frames = min(args.frames, len(ds)) if args.seq else args.frames
    for i in range(n_frames):
        if args.seq:
            left, right, _ = ds.frame(i)
            frames = [(jnp.asarray(left), jnp.asarray(right))]
        else:
            frames = [ds_fwd.frame(i)[:2], ds_cir.frame(i)[:2]]
        for l, r in frames:
            f = frontend(l, r, cam)
            d = np.asarray(f.feats.desc)[np.asarray(f.feats.valid)]
            descs.append(d)
        if i % 10 == 0:
            print(f"[train-vocab] frame {i}/{args.frames}", file=sys.stderr)
    alld = np.concatenate(descs)
    print(f"[train-vocab] {len(alld)} descriptors → k={args.branching} L={args.depth}",
          file=sys.stderr)
    vocab = train_vocabulary(alld, branching=args.branching, depth=args.depth)
    save_vocabulary(vocab, args.out)
    print(json.dumps({"descriptors": int(len(alld)), "words": vocab.n_words,
                      "out": args.out}))


def main(argv=None):
    from .utils import setup_compile_cache

    setup_compile_cache()
    p = argparse.ArgumentParser(prog="orb_slam2_ros2_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("kitti", "tum", "synth"):
        q = sub.add_parser(name)
        q.add_argument("--seq", default="")
        q.add_argument("--config", default="")
        q.add_argument("--frames", type=int, default=0)
        q.add_argument("--out", default="trajectory")
        q.add_argument("--save-map", default="",
                       help="map output: *.pb = reference protobuf, dir/ = "
                            "reference txt streams, else native npz")
        q.add_argument("--load-map", default="",
                       help="map input: *.pb, txt-stream directory, or npz stem")
        q.add_argument("--speed", type=float, default=0.8)
        q.add_argument("--circle", action="store_true")
        q.add_argument("--gt", default="", help="ground-truth pose file (auto-detected if omitted)")
        q.add_argument("--trace", default="",
                       help="write a jax.profiler trace (TensorBoard/Perfetto) to this dir")
        q.add_argument("--distributed", action="store_true",
                       help="join a multi-host JAX runtime (SLAM_COORDINATOR / "
                            "SLAM_NUM_PROCESSES / SLAM_PROCESS_ID env vars)")
        q.add_argument("--ba-devices", type=int, default=0,
                       help="shard global BA landmark blocks over N devices")
        q.add_argument("--pipelined", action="store_true",
                       help="pipelined tracking (deployment mode): overlap "
                            "the per-frame host fetch with the next frame's "
                            "device execution; poses return one frame late")
        q.add_argument("--viewer", default="",
                       help="live viewer (reference Viewer.cc): render "
                            "trajectory/map/graph/HUD every --viewer-every "
                            "frames to this directory (and to a window when "
                            "a display exists)")
        q.add_argument("--viewer-every", type=int, default=10)
    tv = sub.add_parser("train-vocab", help="train a BoW vocabulary offline "
                        "(replaces shipping DBoW3's ORBvoc, reference System.cc:92-95)")
    tv.add_argument("--out", default="vocab.npz")
    tv.add_argument("--frames", type=int, default=48)
    tv.add_argument("--branching", type=int, default=10)
    tv.add_argument("--depth", type=int, default=4)
    tv.add_argument("--seq", default="", help="optional KITTI sequence dir (synthetic scenes if omitted)")
    args = p.parse_args(argv)

    if args.cmd == "train-vocab":
        _train_vocab(args)
        return

    # §5.1 tracing: --trace DIR records a jax.profiler trace of the whole run
    # (TensorBoard/Perfetto artifact) — the profiler-hook upgrade over the
    # reference's chrono+RCLCPP ms logging (System.h:55-61)
    if getattr(args, "trace", ""):
        import atexit

        import jax

        jax.profiler.start_trace(args.trace)
        atexit.register(jax.profiler.stop_trace)

    from .io import trajectory as traj_io

    if args.cmd == "kitti":
        from .io.datasets import KittiStereoDataset, load_kitti_gt

        ds = KittiStereoDataset(args.seq)
        h, w = ds.frame(0)[0].shape
        cfg = _build_cfg(args, w, h)
        slam, poses, stamps, wall = run_stereo(ds, cfg, args)
        # KITTI gt row i corresponds to frame i directly
        gt_all = load_kitti_gt(args.seq, args.gt)
        gt = list(gt_all[: len(poses)]) if gt_all is not None else None
    elif args.cmd == "tum":
        from .io.datasets import TumRGBDDataset
        from .pipeline.system import SLAM
        import jax.numpy as jnp

        ds = TumRGBDDataset(args.seq)
        h, w = ds.frame(0)[0].shape
        cfg = _build_cfg(args, w, h)
        slam = SLAM(cfg, rgbd=True)
        if args.load_map:
            slam.load(args.load_map)
        viewer = _make_viewer(slam, args)
        poses, stamps = [], []
        t0 = time.time()
        n = min(len(ds), args.frames) if args.frames else len(ds)
        for i in range(n):
            gray, depth, stamp = ds.frame(i)
            Tcw, stats = slam.track(jnp.asarray(gray), jnp.asarray(depth))
            poses.append(np.linalg.inv(Tcw) if Tcw is not None else None)
            stamps.append(stamp)
            if viewer is not None:
                viewer.update(Tcw)
        wall = time.time() - t0
        poses = _align_pipelined(slam, poses, n)
        if viewer is not None:
            viewer.close()
        from .io.datasets import associate_gt, load_tum_gt

        tum_gt = load_tum_gt(args.seq, args.gt)
        gt = associate_gt(stamps, *tum_gt) if tum_gt is not None else None
    else:  # synth
        import jax.numpy as jnp

        from .io.synthetic import SyntheticStereoDataset
        from .pipeline.system import SLAM

        n = args.frames or 100
        cfg = _build_cfg(args, 1241, 376)
        ds = SyntheticStereoDataset(cfg.camera, n_frames=n, speed=args.speed, circle=args.circle)
        slam = SLAM(cfg)
        viewer = _make_viewer(slam, args)
        poses, stamps, gt = [], [], []
        t0 = time.time()
        for i in range(n):
            imgL, imgR, Twc_gt = ds.frame(i)
            Tcw, stats = slam.track(imgL, imgR)
            poses.append(np.linalg.inv(Tcw) if Tcw is not None else None)
            stamps.append(i * 0.1)
            gt.append(Twc_gt)
            if viewer is not None:
                viewer.update(Tcw)
            if i % 50 == 0:
                print(f"frame {i}/{n}: {stats}", file=sys.stderr)
        wall = time.time() - t0
        poses = _align_pipelined(slam, poses, n)
        if viewer is not None:
            viewer.close()

    tracked = [p_ for p_ in poses if p_ is not None]
    out = {
        "frames": len(poses),
        "tracked": len(tracked),
        "fps": round(len(poses) / wall, 2),
        "keyframes": slam.n_keyframes,
        "mappoints": slam.n_mappoints,
        "loops_closed": getattr(slam, "loops_closed", 0),
    }
    ft = getattr(slam, "frame_times_ms", [])
    if len(ft) > 4:  # §5.1: per-frame timing (excludes compile-heavy first frames)
        steady = np.asarray(ft[4:])
        out["frame_ms_median"] = round(float(np.median(steady)), 1)
        out["frame_ms_p90"] = round(float(np.percentile(steady, 90)), 1)
    if gt is not None and len(tracked) > len(poses) // 2:
        pairs = [(p_, g) for p_, g in zip(poses, gt) if p_ is not None and g is not None]
        if len(pairs) >= 3:
            out["ate_rmse"] = round(
                traj_io.ate_rmse([a for a, _ in pairs], [b for _, b in pairs]), 4
            )
            out["ate_frames"] = len(pairs)

    filled = [p_ if p_ is not None else np.eye(4) for p_ in poses]
    traj_io.write_kitti(args.out + ".kitti.txt", filled)
    traj_io.write_tum(args.out + ".tum.txt", stamps, filled)
    if args.save_map:
        slam.save(args.save_map)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
