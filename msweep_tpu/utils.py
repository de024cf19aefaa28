"""Shared small utilities: padding, dtype policy, compile cache.

All dense device arrays in this package use the (E, G) = (equivalence
classes, groups) layout: E is the long, sharded axis; G is the row.  G
is padded to a multiple of LANE and E to a multiple of SUBLANE (times
the shard count): the coarse granules keep the number of distinct
compiled shapes small (see inference/pack.pad_dims).

The reference's adaptive integer-width dispatch (include/Likelihood.hpp:334-380,
src/Grouping.cpp:46-88) collapses to numpy dtype choices made in
:func:`min_uint_dtype`.
"""

from __future__ import annotations

import os

import numpy as np

LANE = 128
SUBLANE = 8

# Large negative stand-in for log(0). Finite so that arithmetic like
# NEG - NEG = 0 stays NaN-free, and exp(NEG + anything_reasonable)
# underflows to exactly 0.0 in both f32 and f64: -1e8 is far below the
# exp-underflow knee (~-103 in f32), and small enough that sums of a
# few NEG terms stay exact and finite in f32.
NEG = -1.0e8

# Entries below this are padding (real log-likelihood values are
# O(k log n), never anywhere near NEG).
PAD_THRESHOLD = NEG * 0.5


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_axis(arr: np.ndarray, axis: int, target: int, fill) -> np.ndarray:
    """Pad `arr` along `axis` up to length `target` with `fill`."""
    cur = arr.shape[axis]
    if cur == target:
        return arr
    if cur > target:
        raise ValueError(f"cannot pad axis {axis} from {cur} down to {target}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - cur)
    return np.pad(arr, widths, mode="constant", constant_values=fill)


def min_uint_dtype(max_value: int) -> np.dtype:
    """Smallest unsigned integer dtype that can hold `max_value` (the
    adaptive-width idea from the reference, src/Grouping.cpp:46-88)."""
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if max_value <= np.iinfo(dt).max:
            return np.dtype(dt)
    raise ValueError(f"value {max_value} too large")


def compile_cache_dir(root: str | None = None) -> str | None:
    """Where the persistent compilation cache lives: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then reads it itself), else
    `<checkout>/.jax_cache` — a fixed path, since the path is part of
    the cache key."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def setup_compile_cache(root: str | None = None) -> None:
    """Point JAX's persistent compilation cache at compile_cache_dir()."""
    import jax

    path = compile_cache_dir(root)
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
