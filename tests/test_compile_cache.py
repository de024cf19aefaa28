"""Where the persistent compilation cache goes: JAX_COMPILATION_CACHE_DIR
when it is set (the program then sets no directory in code), else
`<checkout>/.jax_cache`."""

import os
import subprocess
import sys

import pytest

from msweep_tpu.utils import compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
import jax, jax.numpy as jnp
from msweep_tpu.utils import setup_compile_cache
setup_compile_cache(root=sys.argv[1])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(16)))
"""


def test_cache_dir_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    assert compile_cache_dir("/x") == "/x/.jax_cache"


def test_cache_dir_env_wins(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere")
    assert compile_cache_dir() is None


@pytest.mark.parametrize("with_env", [True, False])
def test_compiled_entries_land_in_one_place(tmp_path, with_env):
    checkout, env_dir = tmp_path / "checkout", tmp_path / "env_cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if with_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    r = subprocess.run([sys.executable, "-c", _CHILD, str(checkout)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    in_checkout = list((checkout / ".jax_cache").glob("*")) if checkout.exists() else []
    in_env = list(env_dir.glob("*")) if env_dir.exists() else []
    if with_env:
        assert in_env and not in_checkout
    else:
        assert in_checkout and not in_env
