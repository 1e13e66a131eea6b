"""SLAM engine in JAX with the capabilities of sunshanlu/ORB_SLAM2_ROS2.

A brand-new JAX/XLA design — batched, functional, statically shaped —
not a port of the reference's C++ thread-and-pointer architecture.  See
SURVEY.md for the component inventory this framework implements.
"""

import jax as _jax

# On the GPU, f32 matmuls may run in TF32 (10-bit mantissa) unless asked not
# to.  SLAM geometry cannot survive that: pose-chain 4×4 products lose
# orthonormality per frame and the GN normal equations (entries ~fx² ≈ 5e5)
# round to garbage.  Force full-f32 matmul precision; the deliberately-bf16
# kernels (hamming bit-sign matmuls) pass bf16 inputs explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import SLAMConfig  # noqa: F401

__version__ = "0.1.0"
