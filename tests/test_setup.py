"""Package set-up: the compile-cache location and the imports the main path
needs.  Each case runs in a fresh interpreter, since both are decided at
import or first use."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env):
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()


_CACHE_PROBE = (
    "import jax\n"
    "from orb_slam2_ros2_tpu.utils import setup_compile_cache\n"
    "print(setup_compile_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def test_compile_cache_honours_env(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    returned, configured = _run(_CACHE_PROBE, env)[-2:]
    assert returned == str(tmp_path)
    assert configured == str(tmp_path)


def test_compile_cache_defaults_inside_checkout():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    returned, configured = _run(_CACHE_PROBE, env)[-2:]
    assert returned == configured == os.path.join(ROOT, ".jax_cache")


@pytest.mark.smoke
def test_main_path_imports_without_pyyaml():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import orb_slam2_ros2_tpu.pipeline.system\n"
        "import orb_slam2_ros2_tpu.cli\n"
        "print('ok')\n"
    )
    assert _run(code, env)[-1] == "ok"
