"""Fused Pallas (Triton route) rcg/EM kernels vs the XLA step, in
interpret mode on the CPU.

The kernel path (ops/rcg_pallas.py) carries gamma IMPLICITLY as (c, v)
with gamma = rownorm(c*logL + v) — it must reproduce the explicit XLA
implementation's trajectory (same gamma, bound, iteration count to f32
round-off) because the CLI picks it automatically on the GPU.
"""

import numpy as np
import jax
import jax.numpy as jnp

from msweep_tpu.inference.mixture import bound_const
from msweep_tpu.inference.rcg import (
    _fit_rcg_arrays,
    _rcg_chunk,
    _rcg_init,
    _rcg_init_implicit,
)
from msweep_tpu.ops import rcg_pallas, rcg_xla


def _problem(E=64, G=384, seed=0):
    rng = np.random.default_rng(seed)
    logL = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12)
    counts = rng.integers(1, 40, size=E).astype(np.float64)
    alpha = np.ones(G)
    bc = bound_const(counts, alpha)
    return (
        jnp.asarray(logL, jnp.float32),
        jnp.asarray(counts, jnp.float32),
        jnp.asarray(alpha, jnp.float32),
        bc,
    )


def test_supports_gate():
    logL, *_ = _problem(E=64, G=384)
    assert rcg_pallas.supports(logL)
    assert not rcg_pallas.supports(logL.astype(jnp.float64))
    assert rcg_pallas.supports(jnp.zeros((7, 600), jnp.float32))  # masked loads
    assert not rcg_pallas.supports(jnp.zeros((64, 8192), jnp.float32))  # G too wide
    # Tiles are powers of two holding 4096 f32 cells.
    assert rcg_pallas.tile_shape(512) == (8, 512)
    assert rcg_pallas.tile_shape(640) == (4, 1024)
    assert rcg_pallas.tile_shape(4096) == (1, 4096)


def test_implicit_init_matches_explicit():
    logL, counts, alpha, bc = _problem()
    st_x = _rcg_init(logL, counts, alpha, bc)
    st_i = _rcg_init_implicit(logL, counts, alpha, bc)
    # (c, v) = (0, 0) must materialize to the explicit gamma_0.
    g0 = rcg_xla.materialize_gamma(logL, st_i.c.astype(jnp.float32),
                                      st_i.v.astype(jnp.float32))
    np.testing.assert_allclose(np.asarray(g0), np.asarray(st_x.gamma),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(st_i.bound), float(st_x.bound), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(st_i.n_counts),
                               np.asarray(st_x.n_counts), rtol=1e-12)


def test_pallas_step_matches_xla_step():
    logL, counts, alpha, bc = _problem()
    kw = dict(length=5, tol=1e-6)
    st_x, _ = _rcg_chunk(_rcg_init(logL, counts, alpha, bc),
                         logL, counts, alpha, impl="xla", **kw)
    st_p, _ = _rcg_chunk(_rcg_init_implicit(logL, counts, alpha, bc),
                         logL, counts, alpha, impl="pallas_interpret", **kw)
    g_p = rcg_xla.materialize_gamma(logL, st_p.c.astype(jnp.float32),
                                       st_p.v.astype(jnp.float32))
    np.testing.assert_allclose(np.asarray(g_p), np.asarray(st_x.gamma), rtol=0, atol=2e-5)
    # f32 partials are grouped differently (row sums vs block sums), so
    # the f64 totals agree only to f32 round-off of the partials.
    np.testing.assert_allclose(float(st_p.bound), float(st_x.bound), rtol=1e-6)
    np.testing.assert_allclose(float(st_p.oldnorm), float(st_x.oldnorm), rtol=1e-4)
    assert int(st_p.it) == int(st_x.it)
    assert bool(st_p.done) == bool(st_x.done)


def test_pallas_full_fit_matches_xla():
    logL, counts, alpha, bc = _problem(E=128, G=256, seed=3)
    # refine=False: this compares the f32 kernel trajectories; the
    # production escalation past the floor is covered by test_synth.py.
    kw = dict(tol=1e-6, max_iters=200, verbose=False, refine=False)
    g_x, it_x, b_x = _fit_rcg_arrays(logL, counts, alpha, bc, impl="xla", **kw)
    g_p, it_p, b_p = _fit_rcg_arrays(logL, counts, alpha, bc, impl="pallas_interpret", **kw)
    # Near tol the per-iteration delta is in the f32 noise regime, so the
    # exact stopping iteration may differ by a few steps; the converged
    # bound and abundances must still agree.
    assert abs(int(it_p) - int(it_x)) <= max(5, int(it_x) // 10)
    # Implicit gamma is RECOMPUTED as c*logL + v each pass, so its f32
    # rounding differs from a carried buffer's by O(eps) per iteration.
    np.testing.assert_allclose(float(b_p), float(b_x), rtol=2e-7)
    # f32 round-off compounds over ~hundreds of CG iterations, so the two
    # trajectories agree to optimizer tolerance, not machine eps: compare
    # the normalized abundances.
    theta_x = np.asarray(jnp.sum(counts[:, None] * jnp.exp(g_x), axis=0))
    theta_p = np.asarray(jnp.sum(counts[:, None] * jnp.exp(g_p), axis=0))
    theta_x = theta_x / theta_x.sum()
    theta_p = theta_p / theta_p.sum()
    np.testing.assert_allclose(theta_p, theta_x, rtol=5e-3, atol=1e-6)


def test_pallas_revert_at_numerical_floor():
    # tol=0 can never satisfy 0 <= delta < tol, so the fit runs to the
    # numerical floor where the bound DECREASES — exercising the implicit
    # path's O(G)-state revert + momentum-reset cond.  It must terminate
    # (decrease after a pure-VB step => done) with a bound matching the
    # explicit path's floor.
    logL, counts, alpha, bc = _problem(E=64, G=128, seed=13)
    # refine=False: this test is about the f32 floor itself — the
    # production default would escalate to f64 past it (test_synth.py).
    kw = dict(tol=0.0, max_iters=300, verbose=False, chunk=8, refine=False)
    g_x, it_x, b_x = _fit_rcg_arrays(logL, counts, alpha, bc, impl="xla", **kw)
    g_p, it_p, b_p = _fit_rcg_arrays(logL, counts, alpha, bc, impl="pallas_interpret", **kw)
    assert int(it_x) < 300, "expected the explicit path to hit the floor and stop"
    assert int(it_p) < 300, "expected the implicit path to hit the floor and stop"
    np.testing.assert_allclose(float(b_p), float(b_x), rtol=1e-6)
    np.testing.assert_allclose(np.exp(np.asarray(g_p)), np.exp(np.asarray(g_x)),
                               rtol=0, atol=1e-4)


def test_pallas_padding_inert():
    # Padded rows (counts 0, logL NEG) and padded group columns must not
    # change results vs an unpadded problem run through the same kernels.
    # Padding changes how f32 block partials are grouped, so agreement is
    # to f32 round-off over a fixed iteration budget (tol<0 = no early
    # stop), not bit-exact.
    from msweep_tpu.utils import NEG

    logL, counts, alpha, bc = _problem(E=56, G=256, seed=11)
    E, G = logL.shape
    Lp = jnp.full((E + 8, G + 128), NEG, jnp.float32).at[:E, :G].set(logL)
    cp = jnp.zeros((E + 8,), jnp.float32).at[:E].set(counts)
    ap = jnp.ones((G + 128,), jnp.float32).at[:G].set(alpha)
    kw = dict(tol=-1.0, max_iters=8, verbose=False)
    g0, it0, b0 = _fit_rcg_arrays(logL, counts, alpha, bc, impl="pallas_interpret", **kw)
    g1, it1, b1 = _fit_rcg_arrays(Lp, cp, ap, bc, impl="pallas_interpret", **kw)
    assert int(it0) == int(it1) == 8
    np.testing.assert_allclose(float(b0), float(b1), rtol=1e-7)
    np.testing.assert_allclose(
        np.asarray(g1[:E, :G]), np.asarray(g0), rtol=0, atol=1e-4
    )


import pytest


@pytest.mark.parametrize("E,G,seed", [(128, 256, 5), (512, 128, 11)])
def test_em_pallas_matches_xla(E, G, seed):
    """Cross-impl EM agreement (mirrors the rcg coverage above).

    Tolerance rationale: the reference's own EM trajectory is
    precision-sensitive (docs/gpubenchmarks.md:20-25 — float vs double
    changes the iteration count from 5000-cap to 335), so impl-to-impl
    we assert (a) objective agreement to ~f32 resolution of its
    magnitude, (b) a bounded stopping-iteration gap (tol must sit above
    the f32 noise floor for stopping to be comparable at all), and
    (c) theta agreement to FILE precision — the reference writes
    abundances with 6 significant digits (default ostream precision,
    SURVEY.md section 9.10), so 1e-6 absolute on theta is what
    "identical output" means.  Raw log-prob cells are NOT compared:
    groups driven to theta=0 legitimately sit at NEG in one impl and
    merely-very-negative values in the other.
    """
    from msweep_tpu.inference.em import _fit_em_arrays
    from msweep_tpu.inference.mixture import mixture_components

    logL, counts, alpha, _ = _problem(E=E, G=G, seed=seed)
    kw = dict(tol=1e-4, max_iters=500, verbose=False)
    g_x, it_x, o_x = _fit_em_arrays(logL, counts, alpha, impl="xla", **kw)
    g_p, it_p, o_p = _fit_em_arrays(logL, counts, alpha, impl="pallas_interpret", **kw)
    assert abs(int(it_p) - int(it_x)) <= max(5, int(it_x) // 10)
    # Different stopping iterations leave an O(tol) objective gap.
    np.testing.assert_allclose(float(o_p), float(o_x), rtol=1e-5)
    # Compare probabilities, not log-probs (see docstring).
    np.testing.assert_allclose(
        np.exp(np.asarray(g_p)), np.exp(np.asarray(g_x)), rtol=0, atol=2e-3
    )
    # theta to file precision: 6 significant digits of the written
    # abundances; components are <= 1 so 1e-6 absolute covers it.  The
    # comparison runs both impls the SAME number of iterations (bench
    # mode) — at tol=1e-4 the two stop 1-2 iterations apart and carry an
    # O(1e-4) theta gap that is stopping-rule noise, not impl
    # disagreement (the reference itself documents trajectory
    # sensitivity, docs/gpubenchmarks.md:20-25).
    fixed = dict(tol=-1.0, max_iters=200, verbose=False, chunk=50)
    g_x2, _, _ = _fit_em_arrays(logL, counts, alpha, impl="xla", **fixed)
    g_p2, _, _ = _fit_em_arrays(logL, counts, alpha, impl="pallas_interpret", **fixed)
    th_x = np.asarray(mixture_components(g_x2, counts))
    th_p = np.asarray(mixture_components(g_p2, counts))
    np.testing.assert_allclose(th_p, th_x, rtol=0, atol=1e-6)


def test_em_deferred_delta_converges():
    # The deferred-delta single-pass EM must still converge to the planted
    # mixture and report a finite objective.
    from msweep_tpu.inference.em import _fit_em_arrays
    from msweep_tpu.inference.mixture import mixture_components

    rng = np.random.default_rng(9)
    G, E = 3, 120
    theta_true = np.array([0.6, 0.3, 0.1])
    comp = rng.choice(G, size=E, p=theta_true)
    logL = np.full((E, 128), -80.0, np.float32)
    for e in range(E):
        logL[e, comp[e]] = 0.0
        logL[e, (comp[e] + 1) % G] = -3.0
    counts = np.repeat(25.0, E).astype(np.float32)
    g, it, obj = _fit_em_arrays(
        jnp.asarray(logL), jnp.asarray(counts),
        jnp.ones(128, jnp.float32), tol=1e-7, max_iters=2000,
        verbose=False, impl="pallas_interpret",
    )
    assert np.isfinite(float(obj))
    theta = np.asarray(mixture_components(g, jnp.asarray(counts), 3))
    np.testing.assert_allclose(theta, theta_true, atol=0.12)


def test_pallas_sharded_matches_single():
    # shard_map + psum pallas path (interpret) on an 8-device CPU mesh
    # must reproduce the unsharded pallas trajectory.
    from msweep_tpu.parallel.mesh import make_ec_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    logL, counts, alpha, bc = _problem(E=256, G=256, seed=21)
    kw = dict(tol=-1.0, max_iters=12, verbose=False)
    g0, it0, b0 = _fit_rcg_arrays(logL, counts, alpha, bc, impl="pallas_interpret", **kw)

    mesh = make_ec_mesh(8)
    logL_s = jax.device_put(logL, NamedSharding(mesh, P("ec", None)))
    counts_s = jax.device_put(counts, NamedSharding(mesh, P("ec")))
    alpha_s = jax.device_put(alpha, NamedSharding(mesh, P()))
    g1, it1, b1 = _fit_rcg_arrays(
        logL_s, counts_s, alpha_s, bc, impl="pallas_interpret", mesh=mesh, **kw
    )
    assert int(it0) == int(it1) == 12
    np.testing.assert_allclose(float(b0), float(b1), rtol=1e-6)
    np.testing.assert_allclose(
        np.exp(np.asarray(g1)), np.exp(np.asarray(g0)), rtol=0, atol=1e-4
    )


def test_em_pallas_sharded_matches_single():
    # The EM fused kernel under shard_map + psum on an 8-device CPU mesh
    # (interpret) must reproduce the unsharded pallas trajectory — the
    # reference runs em_torch on the same distributed infrastructure as
    # rcg (src/mSWEEP.cpp:202).
    from msweep_tpu.inference.em import _fit_em_arrays
    from msweep_tpu.parallel.mesh import make_ec_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    logL, counts, alpha, _ = _problem(E=256, G=256, seed=23)
    kw = dict(tol=-1.0, max_iters=12, verbose=False)
    g0, it0, o0 = _fit_em_arrays(logL, counts, alpha, impl="pallas_interpret", **kw)

    mesh = make_ec_mesh(8)
    logL_s = jax.device_put(logL, NamedSharding(mesh, P("ec", None)))
    counts_s = jax.device_put(counts, NamedSharding(mesh, P("ec")))
    alpha_s = jax.device_put(alpha, NamedSharding(mesh, P()))
    g1, it1, o1 = _fit_em_arrays(
        logL_s, counts_s, alpha_s, impl="pallas_interpret", mesh=mesh, **kw
    )
    assert int(it0) == int(it1) == 12
    np.testing.assert_allclose(float(o0), float(o1), rtol=1e-6)
    np.testing.assert_allclose(
        np.exp(np.asarray(g1)), np.exp(np.asarray(g0)), rtol=0, atol=1e-4
    )


def test_em_fit_mesh_dispatch():
    # fit_em on a meshed problem must thread the mesh into the kernel
    # wrapper (round-1 bug: the mesh was accepted then dropped, so the
    # pallas impl ran bare pallas_call on globally-sharded arrays).
    import msweep_tpu.inference.em as em_mod
    from msweep_tpu.inference.em import _fit_em_arrays

    logL, counts, alpha, _ = _problem(E=256, G=256, seed=29)
    from msweep_tpu.parallel.mesh import make_ec_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_ec_mesh(8)
    logL_s = jax.device_put(logL, NamedSharding(mesh, P("ec", None)))
    counts_s = jax.device_put(counts, NamedSharding(mesh, P("ec")))
    alpha_s = jax.device_put(alpha, NamedSharding(mesh, P()))
    seen = {}
    orig = em_mod._make_kernels

    def spy(mesh_arg, interpret):
        seen["mesh"] = mesh_arg
        return orig(mesh_arg, interpret)

    em_mod._make_kernels, saved = spy, orig
    try:
        # chunk=5 gives this call a unique static scan length, so the
        # jit cache can't serve a pre-spy compilation (chunks are now
        # fixed-length across the whole fit, shared via max_it).
        _fit_em_arrays(
            logL_s, counts_s, alpha_s, tol=-1.0, max_iters=2, verbose=False,
            impl="pallas_interpret", mesh=mesh, chunk=5,
        )
    finally:
        em_mod._make_kernels = saved
    assert seen["mesh"] is mesh


# ---------------------------------------------------------------------------
# Batched (bootstrap) implicit fit
# ---------------------------------------------------------------------------


def _bootstrap_batch(counts, B, seed=3):
    rng = np.random.default_rng(seed)
    c = np.asarray(counts, np.float64)
    p = c / c.sum()
    return rng.multinomial(int(c.sum()), p, size=B).astype(np.float64)


def test_batch_implicit_matches_serial():
    # The batched kernels (one logL stream for all B replicates) must
    # reproduce per-replicate serial implicit fits: same iteration
    # counts, same bounds, theta to f32 round-off.
    from msweep_tpu.inference.pack import DeviceProblem
    from msweep_tpu.inference.rcg import fit_rcg_batch, _fit_rcg_arrays

    logL, counts, alpha, bc = _problem(E=64, G=256, seed=31)
    prob = DeviceProblem(
        logL=logL, counts=counts, alpha=alpha, n_ecs=64, n_groups=256,
        bound_const=bc, mesh=None,
    )
    B = 4
    batch = jnp.asarray(_bootstrap_batch(counts, B), jnp.float32)
    tb, ib, bb = fit_rcg_batch(prob, batch, tol=1e-6, max_iters=300,
                               impl="pallas_interpret")
    assert tb.shape == (B, 256)
    for b in range(B):
        # refine=False: the batched kernels intentionally do not
        # escalate (bootstrap CI noise dwarfs the f32 floor), so the
        # serial comparison must not either.
        g1, i1, b1 = _fit_rcg_arrays(
            logL, batch[b], alpha, bc, tol=1e-6, max_iters=300,
            verbose=False, impl="pallas_interpret", refine=False,
        )
        assert int(ib[b]) == int(i1), f"replicate {b} iteration mismatch"
        np.testing.assert_allclose(float(bb[b]), float(b1), rtol=1e-6)
        th1 = np.sum(np.asarray(batch[b])[:, None] * np.exp(np.asarray(g1)), axis=0)
        th1 /= np.asarray(batch[b]).sum()
        np.testing.assert_allclose(np.asarray(tb[b]), th1, rtol=0, atol=2e-6)
    # Replicate thetas sum to 1 over real groups.
    np.testing.assert_allclose(np.asarray(tb).sum(axis=1), 1.0, rtol=1e-5)


def test_batch_implicit_sharded_matches_single():
    # shard_map + psum batched kernels on an 8-device CPU mesh must
    # reproduce the unsharded batched trajectory (the lifted
    # multi-process bootstrap path, reference docs/compilation.md:40-58).
    from msweep_tpu.inference.pack import DeviceProblem
    from msweep_tpu.inference.rcg import fit_rcg_batch
    from msweep_tpu.parallel.mesh import make_ec_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    logL, counts, alpha, bc = _problem(E=256, G=256, seed=37)
    B = 3
    batch = jnp.asarray(_bootstrap_batch(counts, B, seed=5), jnp.float32)

    prob0 = DeviceProblem(
        logL=logL, counts=counts, alpha=alpha, n_ecs=256, n_groups=256,
        bound_const=bc, mesh=None,
    )
    # Fixed iteration budget (tol<0): sharded f32 partials are grouped
    # differently, so near-tol stopping iterations can differ by a step —
    # the trajectory itself must match (same pattern as
    # test_pallas_sharded_matches_single).
    kw = dict(tol=-1.0, max_iters=12, impl="pallas_interpret")
    t0, i0, b0 = fit_rcg_batch(prob0, batch, **kw)

    mesh = make_ec_mesh(8)
    logL_s = jax.device_put(logL, NamedSharding(mesh, P("ec", None)))
    counts_s = jax.device_put(counts, NamedSharding(mesh, P("ec")))
    alpha_s = jax.device_put(alpha, NamedSharding(mesh, P()))
    prob1 = DeviceProblem(
        logL=logL_s, counts=counts_s, alpha=alpha_s, n_ecs=256, n_groups=256,
        bound_const=bc, mesh=mesh,
    )
    t1, i1, b1 = fit_rcg_batch(prob1, batch, **kw)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(b0), np.asarray(b1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(t0), np.asarray(t1), rtol=0, atol=1e-5)


def test_em_batch_returns_theta():
    # fit_em_batch returns (theta, iters, objective) with theta summing
    # to 1 and matching mixture_components of a serial EM fit.
    from msweep_tpu.inference.pack import DeviceProblem
    from msweep_tpu.inference.em import fit_em_batch, _fit_em_arrays
    from msweep_tpu.inference.mixture import mixture_components

    logL, counts, alpha, bc = _problem(E=64, G=128, seed=41)
    prob = DeviceProblem(
        logL=logL, counts=counts, alpha=alpha, n_ecs=64, n_groups=128,
        bound_const=bc, mesh=None,
    )
    B = 3
    batch = jnp.asarray(_bootstrap_batch(counts, B, seed=7), jnp.float32)
    tb, ib, ob = fit_em_batch(prob, batch, tol=1e-7, max_iters=500)
    assert tb.shape == (B, 128)
    np.testing.assert_allclose(np.asarray(tb).sum(axis=1), 1.0, rtol=1e-5)
    for b in range(B):
        g1, i1, o1 = _fit_em_arrays(
            logL, batch[b], alpha, tol=1e-7, max_iters=500, verbose=False,
            impl="xla",
        )
        th1 = np.asarray(mixture_components(g1, batch[b]))
        assert int(ib[b]) == int(i1)
        np.testing.assert_allclose(np.asarray(tb[b]), th1, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# Single passes against the plain reference (interpret mode): the padded
# widths the GPU sees, and a ragged last row block.
# ---------------------------------------------------------------------------


def _pass_inputs(E, G, seed=0):
    from msweep_tpu.utils import NEG

    Gp = -(-G // 128) * 128
    rng = np.random.default_rng(seed)
    L = np.full((E, Gp), NEG, np.float32)
    L[:, :G] = np.log(rng.dirichlet(np.ones(G) * 0.3, size=E) + 1e-12)
    gmask = np.arange(Gp) < G
    counts = rng.integers(1, 40, size=(E, 1)).astype(np.float32)
    psi = np.where(gmask, rng.normal(size=Gp), 0.0)[None, :]
    v = np.where(gmask, 0.1 * rng.normal(size=Gp), 0.0)[None, :]
    return jnp.asarray(L), jnp.asarray(counts), psi, v


# (E, G): G_pad 512 with a whole last tile; G_pad 640 (tile width 1024)
# with a ragged last row block; a width below one tile.
PASS_SHAPES = [(256, 512), (203, 600), (37, 100)]


@pytest.mark.parametrize("E,G", PASS_SHAPES)
def test_rcg_passes_match_reference(E, G):
    """Norm and update passes against ops/rcg_xla in f64 (the tolerances
    chip_smoke.py holds the compiled kernels to: norm and colsum rtol
    1e-4, ELBO delta 1e-6 of the data term)."""
    L, counts, psi, v = _pass_inputs(E, G)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    f64 = lambda x: jnp.asarray(x, jnp.float64)
    v2 = 0.9 * v + 0.1 * psi
    n_k = rcg_pallas.rcg_norm(L, counts, f32(psi), 0.7, f32(v), interpret=True)
    n_r = rcg_xla.rcg_norm(L, counts, f64(psi), f64(0.7), f64(v))
    np.testing.assert_allclose(float(n_k), float(n_r), rtol=1e-4)
    cs_k, el_k = rcg_pallas.rcg_update(L, counts, 0.7, f32(v), 0.8, f32(v2),
                                       interpret=True)
    cs_r, el_r = rcg_xla.rcg_update(L, counts, f64(0.7), f64(v), f64(0.8), f64(v2))
    data, _ = rcg_xla.rcg_bound_stats(L, counts, f64(0.7), f64(v))
    assert cs_k.shape == (L.shape[1],)
    np.testing.assert_allclose(np.asarray(cs_k), np.asarray(cs_r), rtol=1e-4,
                               atol=1e-4 * float(np.max(np.asarray(cs_r))))
    assert abs(float(el_k) - float(el_r)) <= 1e-6 * abs(float(data))


@pytest.mark.parametrize("E,G", PASS_SHAPES)
def test_em_pass_matches_reference(E, G):
    from msweep_tpu.ops import em_pallas
    from msweep_tpu.utils import NEG

    L, counts, _, _ = _pass_inputs(E, G, seed=1)
    rng = np.random.default_rng(2)
    theta_prev = rng.dirichlet(np.ones(G))
    theta = theta_prev * np.exp(0.1 * rng.normal(size=G))
    lse, colsum, ddot, ref = _em_pass(L, counts[:, 0], theta_prev, theta / theta.sum())
    lse_r, colsum_r, ddot_r = ref
    assert lse.shape == (E,) and colsum.shape == (L.shape[1],)
    np.testing.assert_allclose(np.asarray(lse), lse_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(colsum), colsum_r, rtol=1e-4,
                               atol=1e-4 * colsum_r.max())
    np.testing.assert_allclose(float(ddot), ddot_r, rtol=1e-5)


def _em_pass(L, c, theta_prev, theta):
    """The fused EM pass (interpret mode) from theta_prev to theta, and
    its f64 reference (lse, colsum, sum_e c_e (lse_e - lse_prev_e))."""
    from msweep_tpu.ops import em_pallas
    from msweep_tpu.utils import NEG

    E, Gp = L.shape
    G = len(theta)
    pad = lambda x: np.where(np.arange(Gp) < G, np.log(np.pad(x, (0, Gp - G)) + 1e-300), NEG)
    L64 = np.asarray(L, np.float64)

    def lse_at(logtheta):
        t = L64 + logtheta[None, :]
        m = t.max(axis=1, keepdims=True)
        return t, (m + np.log(np.exp(t - m).sum(axis=1, keepdims=True)))[:, 0]

    _, lse_prev = lse_at(pad(theta_prev))
    t, lse_r = lse_at(pad(theta))
    q = np.pad(1.0 - theta_prev / theta, (0, Gp - G))
    c64 = np.asarray(c, np.float64)
    colsum_r = (c64[:, None] * np.exp(t - lse_r[:, None])).sum(axis=0)
    # The previous pass hands lse_prev over in f32; its rounding scales
    # the change by exp(-rounding), so ddot still tracks the exact change.
    lse, colsum, ddot = em_pallas.em_step(
        L, c, jnp.asarray(lse_prev, jnp.float32), jnp.asarray(pad(theta), jnp.float32),
        q, interpret=True,
    )
    ddot_r = float(np.sum(c64 * (lse_r - lse_prev)))
    return lse, colsum, ddot, (lse_r, colsum_r, ddot_r)


@pytest.mark.parametrize("step", [1e-4, 1e-6])
def test_em_delta_resolves_small_changes(step):
    """Near convergence the objective change is far below f32 resolution
    of a row's lse: the kernel's log1p form keeps its error relative to
    the change (a difference of two f32 lse values would be off by about
    |lse| * 6e-8 per row, far more than the whole change at step 1e-6)."""
    L, counts, _, _ = _pass_inputs(256, 512, seed=3)
    rng = np.random.default_rng(4)
    theta_prev = rng.dirichlet(np.ones(512))
    theta = theta_prev * np.exp(step * rng.normal(size=512))
    theta /= theta.sum()
    _, _, ddot, (_, _, exact) = _em_pass(L, counts[:, 0], theta_prev, theta)
    assert abs(float(ddot) - exact) <= 1e-3 * abs(exact)


def test_kernel_grid_covers_rows_once():
    """Every row block is visited by exactly one program: a count-only
    problem (logL all zero, psi = v = 0) gives colsum = counts spread
    uniformly, whatever E and the program count are."""
    for E in (1, 7, 9, 4097):
        G = 128
        L = jnp.zeros((E, G), jnp.float32)
        counts = jnp.ones((E, 1), jnp.float32)
        z = jnp.zeros((1, G), jnp.float32)
        colsum, elbo = rcg_pallas.rcg_update(L, counts, 0.0, z, 0.0, z, interpret=True)
        np.testing.assert_allclose(np.asarray(colsum), E / G, rtol=1e-6)
        assert float(elbo) == 0.0


def test_bootstrap_init_counts_above_tf32():
    """The batched init contracts (B, E) counts against exp(gamma_0): with
    EC counts above 2048 a TF32 product would round them, so the
    contractions ask for HIGHEST precision and must match an f64 sum."""
    from msweep_tpu.inference.rcg import _rcg_init_implicit_batch

    logL, counts, alpha, bc = _problem(E=64, G=128, seed=43)
    rng = np.random.default_rng(3)
    batch = rng.integers(2049, 20000, size=(3, 64)).astype(np.float32)
    args = (logL, jnp.asarray(batch), alpha, bc, float(alpha.sum()), float(counts.sum()))
    st = _rcg_init_implicit_batch(*args)
    # gamma_0 is uniform over the G real groups: N_0 = alpha + sum_e c_e / G.
    G = logL.shape[1]
    n0 = 1.0 + np.repeat(batch.astype(np.float64).sum(axis=1, keepdims=True) / G, G, axis=1)
    np.testing.assert_allclose(np.asarray(st.n_counts), n0, rtol=1e-6)
    jaxpr = jax.make_jaxpr(_rcg_init_implicit_batch)(*args)
    dots = [e for e in jaxpr.eqns[0].params["jaxpr"].eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2
