"""Test configuration: the CPU backend with 8 virtual devices, and x64.

The 8 virtual CPU devices are the multi-device test rig (SURVEY.md
section 6: the analog of the reference's MPI rank-count-invariance
checks).  Tests marked `gpu` need an NVIDIA GPU: run them with
JAX_PLATFORMS=cuda (which this file then leaves alone); elsewhere they
skip.
"""

import os
import sys

ON_GPU = os.environ.get("JAX_PLATFORMS") == "cuda"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "true"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
