"""Multi-device tests on the 8-way virtual CPU mesh (SURVEY.md section 6 tier 4):
shard-count invariance of results — the analog of the reference's
MPI rank-invariance property (docs/compilation.md:40-58)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from msweep_tpu.core.likelihood import Likelihood
from msweep_tpu.inference import fit_rcg, fit_em, mixture_components, pack_problem
from msweep_tpu.parallel.mesh import make_ec_mesh


def _lik(E=200, G=5, seed=0):
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.5, size=E) + 1e-9)
    counts = rng.integers(1, 100, size=E)
    return Likelihood(
        n_ecs=E,
        n_groups_total=G,
        groups_mask=np.ones(G, bool),
        group_sizes=np.ones(G, np.int64),
        ec_counts=counts.astype(np.int64),
        zero_inflation=0.01,
        _dense=logL,
    )


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_rcg_shard_invariance(n_shards):
    lik = _lik()
    p_single = pack_problem(lik)
    g1, i1, b1 = fit_rcg(p_single, tol=1e-9)

    mesh = make_ec_mesh(n_shards)
    assert mesh is not None
    p_shard = pack_problem(lik, mesh=mesh)
    assert len(p_shard.logL.sharding.device_set) == n_shards
    g2, i2, b2 = fit_rcg(p_shard, tol=1e-9)

    assert int(i1) == int(i2), "iteration count must be shard-invariant"
    np.testing.assert_allclose(float(b1), float(b2), rtol=1e-12)
    t1 = np.asarray(mixture_components(g1, p_single.counts, 5))
    t2 = np.asarray(mixture_components(g2, p_shard.counts, 5))
    np.testing.assert_allclose(t1, t2, atol=1e-12)


def test_em_shard_invariance():
    lik = _lik(seed=3)
    p1 = pack_problem(lik)
    p2 = pack_problem(lik, mesh=make_ec_mesh(8))
    g1, i1, o1 = fit_em(p1, tol=1e-10)
    g2, i2, o2 = fit_em(p2, tol=1e-10)
    assert int(i1) == int(i2)
    t1 = np.asarray(mixture_components(g1, p1.counts, 5))
    t2 = np.asarray(mixture_components(g2, p2.counts, 5))
    np.testing.assert_allclose(t1, t2, atol=1e-12)


def test_graft_entry_single_and_multichip():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    gamma, iters, bound = jax.jit(fn)(*args)
    assert np.isfinite(float(bound))

    ge.dryrun_multichip(8)
