"""Optimizer tests (SURVEY.md section 6 tier 2): tiny matrices with known
posteriors, rcg/EM agreement, padding inertness, batch equivalence."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from msweep_tpu.core.likelihood import Likelihood
from msweep_tpu.inference import (
    bound_const,
    fit_em,
    fit_rcg,
    mixture_components,
    pack_problem,
)
from msweep_tpu.inference.rcg import fit_rcg_batch


def make_problem(logL, counts, alpha=None, dtype=jnp.float64):
    logL = np.asarray(logL, dtype=np.float64)
    E, G = logL.shape
    lik = Likelihood(
        n_ecs=E,
        n_groups_total=G,
        groups_mask=np.ones(G, bool),
        group_sizes=np.ones(G, np.int64),
        ec_counts=np.asarray(counts, np.int64),
        zero_inflation=0.01,
        _dense=logL,
    )
    return pack_problem(lik, alpha=alpha, dtype=dtype)


def synthetic(E=200, G=5, seed=0, n_reads=10000):
    """Draw EC counts from a known mixture for recovery tests."""
    rng = np.random.default_rng(seed)
    theta = rng.dirichlet(np.ones(G) * 2)
    # each EC has a random loglik profile; counts ~ mixture marginal
    logL = np.log(rng.dirichlet(np.ones(G) * 0.5, size=E) + 1e-9)
    p_ec = (np.exp(logL) @ theta) / np.sum(np.exp(logL) @ theta)
    counts = rng.multinomial(n_reads, p_ec)
    keep = counts > 0
    return logL[keep], counts[keep], theta


class TestRCG:
    def test_single_ec_posterior(self):
        # One EC aligned overwhelmingly to group 0: gamma ~ one-hot.
        prob = make_problem([[0.0, -30.0]], [10])
        gamma, iters, bound = fit_rcg(prob)
        theta = mixture_components(gamma, prob.counts, prob.n_groups)
        assert theta[0] == pytest.approx(1.0, abs=1e-6)
        assert np.isfinite(float(bound))

    def test_uniform_likelihood_gives_uniform_theta(self):
        prob = make_problem(np.zeros((4, 3)), [5, 5, 5, 5])
        gamma, iters, _ = fit_rcg(prob)
        theta = mixture_components(gamma, prob.counts, prob.n_groups)
        np.testing.assert_allclose(np.asarray(theta), 1 / 3, atol=1e-6)

    def test_elbo_improves_and_converges(self):
        logL, counts, _ = synthetic()
        prob = make_problem(logL, counts)
        gamma, iters, bound = fit_rcg(prob, tol=1e-8, max_iters=2000)
        assert int(iters) < 2000  # converged before cap
        assert np.isfinite(float(bound))
        # result is a proper log-prob matrix on real entries
        rows = np.asarray(jnp.exp(gamma)[: prob.n_ecs]).sum(axis=1)
        np.testing.assert_allclose(rows, 1.0, atol=1e-8)

    def test_agrees_with_em_maximum(self):
        # With many reads the VB posterior mean ~ the EM/ML estimate.
        logL, counts, _ = synthetic(E=300, G=4, n_reads=200000, seed=3)
        prob = make_problem(logL, counts)
        g1, _, _ = fit_rcg(prob, tol=1e-10, max_iters=3000)
        g2, _, _ = fit_em(prob, tol=1e-12, max_iters=20000)
        t1 = np.asarray(mixture_components(g1, prob.counts, prob.n_groups))
        t2 = np.asarray(mixture_components(g2, prob.counts, prob.n_groups))
        np.testing.assert_allclose(t1, t2, atol=2e-3)

    def test_padding_inert(self):
        logL, counts, _ = synthetic(E=64, G=3, seed=1)
        p1 = make_problem(logL, counts)
        # Same data with extra zero-count junk rows appended.
        junk = np.tile(np.log([[0.2, 0.5, 0.3]]), (9, 1))
        p2 = make_problem(np.vstack([logL, junk]), np.concatenate([counts, np.zeros(9, int)]))
        t1 = mixture_components(fit_rcg(p1)[0], p1.counts, 3)
        t2 = mixture_components(fit_rcg(p2)[0], p2.counts, 3)
        np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), atol=1e-9)

    def test_alpha_prior_pulls_theta(self):
        prob_flat = make_problem(np.zeros((2, 2)), [1, 1])
        prob_tilt = make_problem(np.zeros((2, 2)), [1, 1], alpha=np.array([10.0, 1.0]))
        g = fit_rcg(prob_tilt)[0]
        th = mixture_components(g, prob_tilt.counts, 2)
        g0 = fit_rcg(prob_flat)[0]
        th0 = mixture_components(g0, prob_flat.counts, 2)
        assert float(th[0]) > float(th0[0])

    def test_batch_matches_loop(self):
        logL, counts, _ = synthetic(E=50, G=3, seed=2)
        prob = make_problem(logL, counts)
        E_pad = prob.counts.shape[0]
        rng = np.random.default_rng(0)
        batch = np.zeros((3, E_pad))
        for b in range(3):
            batch[b, : len(counts)] = rng.multinomial(
                counts.sum(), counts / counts.sum()
            )
        batch_j = jnp.asarray(batch, prob.counts.dtype)
        tb, ib, bb = fit_rcg_batch(prob, batch_j, tol=1e-8)
        for b in range(3):
            g1, i1, b1 = fit_rcg(prob, counts=batch_j[b], tol=1e-8)
            th1 = mixture_components(g1, batch_j[b])
            np.testing.assert_allclose(np.asarray(tb[b]), np.asarray(th1), atol=1e-7)
            assert int(ib[b]) == int(i1)


class TestEM:
    def test_ml_recovery_two_groups(self):
        # ECs exclusively assigned: theta must equal count fractions.
        logL = np.array([[0.0, -40.0], [-40.0, 0.0]])
        prob = make_problem(logL, [30, 70])
        gamma, iters, obj = fit_em(prob, tol=1e-13)
        theta = mixture_components(gamma, prob.counts, 2)
        np.testing.assert_allclose(np.asarray(theta), [0.3, 0.7], atol=1e-9)

    def test_map_with_prior(self):
        # alpha = [2, 1]: MAP theta = (c0+1, c1) / (n+1)
        logL = np.array([[0.0, -40.0], [-40.0, 0.0]])
        prob = make_problem(logL, [30, 70], alpha=np.array([2.0, 1.0]))
        gamma, _, _ = fit_em(prob, tol=1e-13)
        # mixture_components reports sum c*p / sum c (not theta itself);
        # with exclusive assignment p is one-hot so it returns count fracs.
        theta = mixture_components(gamma, prob.counts, 2)
        np.testing.assert_allclose(np.asarray(theta), [0.3, 0.7], atol=1e-9)

    def test_em_converges_synthetic(self):
        logL, counts, _ = synthetic(E=150, G=4, seed=5)
        prob = make_problem(logL, counts)
        gamma, iters, obj = fit_em(prob, tol=1e-10, max_iters=20000)
        assert int(iters) < 20000
        rows = np.asarray(jnp.exp(gamma)[: prob.n_ecs]).sum(axis=1)
        np.testing.assert_allclose(rows, 1.0, atol=1e-9)


class TestFitResult:
    """The O(G) result path: theta/pseudocounts straight from optimizer
    state, gamma materialized only on demand (reference contract
    src/mSWEEP.cpp:419-423: plain runs consume only theta)."""

    def test_rcg_theta_matches_mixture_components_xla(self):
        from msweep_tpu.inference import fit_rcg_result

        logL, counts, _ = synthetic(E=120, G=4, seed=7)
        prob = make_problem(logL, counts)
        res = fit_rcg_result(prob, tol=1e-8, max_iters=2000)
        gamma, _, _ = fit_rcg(prob, tol=1e-8, max_iters=2000)
        t_ref = np.asarray(mixture_components(gamma, prob.counts))
        np.testing.assert_allclose(np.asarray(res.theta), t_ref, atol=1e-10)
        # .gamma() materializes the same matrix the tuple API returns.
        np.testing.assert_allclose(
            np.asarray(res.gamma()), np.asarray(gamma), atol=0
        )

    def test_rcg_implicit_no_gamma_materialization(self, monkeypatch):
        """Abundances-only fits on the implicit path must never touch
        materialize_gamma: the plain abundances output is O(G) work."""
        from msweep_tpu.inference import fit_rcg_result
        from msweep_tpu.ops import rcg_xla

        logL, counts, _ = synthetic(E=64, G=3, seed=8)
        prob = make_problem(logL, counts, dtype=jnp.float32)

        def boom(*a, **k):
            raise AssertionError("materialize_gamma called on the plain path")

        monkeypatch.setattr(rcg_xla, "materialize_gamma", boom)
        res = fit_rcg_result(prob, tol=1e-6, impl="pallas_interpret")
        theta = np.asarray(res.theta)[: prob.n_groups]
        assert theta.sum() == pytest.approx(1.0, abs=1e-5)
        with pytest.raises(AssertionError):
            res.gamma()  # materialization happens only on demand

    def test_rcg_pseudocounts_are_theta_times_total(self):
        from msweep_tpu.inference import fit_rcg_result

        logL, counts, _ = synthetic(E=80, G=3, seed=9)
        prob = make_problem(logL, counts)
        res = fit_rcg_result(prob, tol=1e-8)
        csum = float(np.sum(counts))
        np.testing.assert_allclose(
            np.asarray(res.pseudocounts), np.asarray(res.theta) * csum, rtol=1e-12
        )

    def test_em_theta_matches_mixture_components(self):
        from msweep_tpu.inference import fit_em_result

        logL, counts, _ = synthetic(E=100, G=4, seed=10)
        prob = make_problem(logL, counts)
        res = fit_em_result(prob, tol=1e-10, max_iters=20000)
        gamma, _, _ = fit_em(prob, tol=1e-10, max_iters=20000)
        t_ref = np.asarray(mixture_components(gamma, prob.counts))
        np.testing.assert_allclose(np.asarray(res.theta), t_ref, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(res.gamma()), np.asarray(gamma), atol=0
        )

    def test_rate_from_pseudocounts_matches_gamma_path(self):
        from msweep_tpu.inference import (
            dirichlet_kld,
            dirichlet_kld_from_pseudocounts,
            fit_rcg_result,
        )

        logL, counts, _ = synthetic(E=90, G=4, seed=11)
        prob = make_problem(logL, counts)
        res = fit_rcg_result(prob, tol=1e-9)
        k1 = np.asarray(dirichlet_kld_from_pseudocounts(res.pseudocounts))
        k2 = np.asarray(dirichlet_kld(res.gamma(), prob.counts))
        np.testing.assert_allclose(k1, k2, atol=1e-8)


def test_bound_const_value():
    # analytic check, G=2, alpha=1, counts sum 3:
    # lgamma(2) - 2*lgamma(1) - lgamma(5) = 0 - 0 - log(24)
    assert bound_const(np.array([1, 2]), np.array([1.0, 1.0])) == pytest.approx(
        -np.log(24.0)
    )


class TestPacking:
    def test_pad_dims_small_exact(self):
        from msweep_tpu.inference.pack import pad_dims

        # below the bucketing threshold: minimal sublane/lane padding only
        assert pad_dims(100, 5) == (104, 128)
        assert pad_dims(4096, 512) == (4096, 512)

    def test_pad_dims_buckets_large(self):
        from msweep_tpu.inference.pack import pad_dims

        # large E buckets at 16 steps per octave so similar-size datasets
        # share compiled executables; power-of-two sizes are unchanged
        e, g = pad_dims(1 << 17, 512)
        assert (e, g) == (1 << 17, 512)
        e199k, _ = pad_dims(199494, 512)
        assert e199k % (1 << 14) == 0 and 199494 <= e199k <= 199494 * 1.07
        # two nearby sizes land in the same bucket
        assert pad_dims(199494, 512) == pad_dims(200001, 512)

    def test_pad_dims_respects_shards(self):
        from msweep_tpu.inference.pack import pad_dims

        for n in (123, 5000, 199494):
            e, _ = pad_dims(n, 64, n_shards=8)
            assert e % (8 * 8) == 0 and e >= n

    def test_auto_chunk(self):
        import numpy as np

        from msweep_tpu.inference.pack import auto_chunk

        small = np.zeros((1 << 10, 128), np.float32)
        big = np.zeros((1 << 19, 512), np.float32)
        assert auto_chunk(small) == 16
        assert auto_chunk(big) == 64
