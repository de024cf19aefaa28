"""Device packing: pad the likelihood problem to a few coarse shapes.

Layout: (E, G) with E (equivalence classes) as the long axis — padded to
a multiple of SUBLANE x the EC-shard count — and G (groups) padded to a
multiple of LANE (see utils).  Padding is inert by construction:

- padded L entries = utils.NEG (log-0 stand-in) so softmax weight is 0,
- padded counts = 0 so padded rows contribute nothing to any reduction,
- padded alpha = 1.0 so lgamma(N_pad)=lgamma(1)=0 drops out of the ELBO.

This replaces the reference's device handoff (whole seamat matrix copied
to the GPU inside rcgpar, SURVEY.md section 4.5) and is where EC-axis sharding
attaches (SURVEY.md section 7 "long-context": shard ECs, replicate groups).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.likelihood import Likelihood
from ..utils import LANE, NEG, SUBLANE, round_up


@dataclass
class DeviceProblem:
    """Padded, device-resident inference inputs."""

    logL: Any  # (E_pad, G_pad) log-likelihood matrix
    counts: Any  # (E_pad,) EC multiplicities (float dtype, 0-padded)
    alpha: Any  # (G_pad,) Dirichlet prior counts (1.0-padded)
    n_ecs: int  # logical E
    n_groups: int  # logical G
    bound_const: float  # constant ELBO terms (see mixture.bound_const)
    mesh: Any = None  # optional jax Mesh with an "ec" axis

    @property
    def padded_shape(self) -> tuple[int, int]:
        return self.logL.shape

    def group_mask(self):
        g = jnp.arange(self.logL.shape[1])
        return g < self.n_groups


def pad_dims(n_ecs: int, n_groups: int, n_shards: int = 1) -> tuple[int, int]:
    e_pad = round_up(max(n_ecs, 1), SUBLANE * n_shards)
    if e_pad > 4096:
        # Bucket the padded EC length (16 buckets per octave, <=6% inert
        # padding): unrelated datasets of similar size then share one
        # compiled executable — and, across processes, one persistent-
        # cache entry — instead of paying a fresh ~100 s XLA compile per
        # distinct EC count.
        granule = 1 << (e_pad.bit_length() - 4)
        e_pad = round_up(round_up(e_pad, granule), SUBLANE * n_shards)
    g_pad = round_up(max(n_groups, 1), LANE)
    return e_pad, g_pad


def pack_problem(
    lik: Likelihood,
    alpha: np.ndarray | None = None,
    dtype=jnp.float64,
    mesh=None,
    counts: np.ndarray | None = None,
) -> DeviceProblem:
    """Pad + transfer a host Likelihood to the device (mesh-sharded if given).

    `alpha` is the --alphas prior (default all 1.0, src/mSWEEP.cpp:391-398).
    `counts` overrides the EC counts (used by bootstrap resampling).
    """
    from .mixture import bound_const as _bound_const

    E, G = lik.n_ecs, lik.n_groups
    n_shards = mesh.shape["ec"] if mesh is not None else 1
    e_pad, g_pad = pad_dims(E, G, n_shards)

    if alpha is None:
        alpha = np.ones(G, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)
    if len(alpha) != G:
        raise ValueError("--alphas must have the same number of values as there are groups")

    if counts is None:
        counts = lik.ec_counts
    counts = np.asarray(counts, dtype=np.float64)

    np_dtype = np.dtype(jnp.dtype(dtype).name)
    host_L = np.full((e_pad, g_pad), NEG, dtype=np_dtype)
    host_L[:E, :G] = lik.dense(dtype=np_dtype)

    host_counts = np.zeros(e_pad, dtype=np_dtype)
    host_counts[:E] = counts.astype(np_dtype)

    host_alpha = np.ones(g_pad, dtype=np_dtype)
    host_alpha[:G] = alpha.astype(np_dtype)

    bc = float(_bound_const(counts, alpha))

    if mesh is not None:
        ec_sharded = NamedSharding(mesh, P("ec", None))
        vec_sharded = NamedSharding(mesh, P("ec"))
        replicated = NamedSharding(mesh, P())
        logL = jax.device_put(host_L, ec_sharded)
        counts_d = jax.device_put(host_counts, vec_sharded)
        alpha_d = jax.device_put(host_alpha, replicated)
    else:
        logL = jnp.asarray(host_L)
        counts_d = jnp.asarray(host_counts)
        alpha_d = jnp.asarray(host_alpha)

    return DeviceProblem(
        logL=logL,
        counts=counts_d,
        alpha=alpha_d,
        n_ecs=E,
        n_groups=G,
        bound_const=bc,
        mesh=mesh,
    )


def auto_chunk(logL) -> int:
    """Scan-chunk length for the optimizer host loops: 16 for small
    problems (limits overshoot past convergence), 64 once the matrix is
    large enough that per-chunk host syncs — and, on the escalation
    tail, the per-window f64 supervision pass — dominate the cost of a
    few extra frozen iterations."""
    return 64 if logL.shape[0] * logL.shape[1] >= (1 << 27) else 16


def acc_dtype():
    """Accumulation dtype for long-axis reductions: f64 when x64 is on.

    The ELBO has magnitude ~sum(counts)*|logL| so convergence at tol=1e-6
    needs f64 scalars even when the matrix itself is f32 (the reference's
    emgpu float/double trajectories differ for exactly this reason,
    docs/gpubenchmarks.md:20-25).
    """
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
