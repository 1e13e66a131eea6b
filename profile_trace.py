#!/usr/bin/env python
"""Capture a jax.profiler trace of the scanned frontend and dump top ops."""
import os, sys, glob, time
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax, jax.numpy as jnp, numpy as np

from orb_slam2_ros2_tpu.utils import setup_compile_cache  # noqa: E402

setup_compile_cache()

from orb_slam2_ros2_tpu.config import SLAMConfig
from orb_slam2_ros2_tpu.features import extractor as ex
from orb_slam2_ros2_tpu.geometry.camera import CameraParams
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset

T = 10
TRACE = "/tmp/jaxtrace"

def main():
    cfg = SLAMConfig()
    cam = CameraParams.from_config(cfg.camera)
    ds = SyntheticStereoDataset(cfg.camera, n_frames=T + 2, speed=0.8)
    stack_l = jnp.stack([jnp.asarray(ds.frame(i)[0]) for i in range(T)])
    stack_r = jnp.stack([jnp.asarray(ds.frame(i)[1]) for i in range(T)])
    np.asarray(stack_l)

    frontend_fn = ex.make_stereo_frontend(cfg)
    fr = frontend_fn.__wrapped__ if hasattr(frontend_fn, "__wrapped__") else frontend_fn

    @jax.jit
    def run(sl, sr):
        def f(c, x):
            out = fr(x[0], x[1], cam)
            red = jax.tree_util.tree_reduce(
                lambda a, b: a + jnp.sum(b.astype(jnp.float32)), out, jnp.float32(0))
            return c + red, ()
        tot, _ = jax.lax.scan(f, jnp.float32(0), (sl, sr))
        return tot

    np.asarray(run(stack_l, stack_r))
    with jax.profiler.trace(TRACE):
        np.asarray(run(stack_l, stack_r))
    print("trace captured", flush=True)

    # parse: find the xplane file and dump op-level stats
    paths = glob.glob(TRACE + "/**/*.xplane.pb", recursive=True)
    print(paths)
    from tensorboard_plugin_profile.convert import raw_to_tool_data
    data, _ = raw_to_tool_data.xspace_to_tool_data(paths, "framework_op_stats^", {})
    open("/tmp/op_stats.csv", "w").write(data if isinstance(data, str) else data.decode())
    print("wrote /tmp/op_stats.csv")

if __name__ == "__main__":
    main()
