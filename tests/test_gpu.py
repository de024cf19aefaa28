"""Checks that need an NVIDIA GPU: the compiled Triton kernels against
the plain reference, and the dispatch that picks them.  chip_smoke.py
runs the same checks at full size.  They skip elsewhere; on a machine
with a GPU run

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


@pytest.mark.parametrize("G", [512, 600])
def test_compiled_kernels_match_reference(gpu, G):
    from test_pallas import _pass_inputs

    from msweep_tpu.ops import em_pallas, rcg_pallas, rcg_xla

    E = 8192 + 37  # a ragged last row block
    L, counts, psi, v = _pass_inputs(E, G)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    f64 = lambda x: jnp.asarray(x, jnp.float64)
    n_k = rcg_pallas.rcg_norm(L, counts, f32(psi), 0.7, f32(v))
    n_r = rcg_xla.rcg_norm(L, counts, f64(psi), f64(0.7), f64(v))
    np.testing.assert_allclose(float(n_k), float(n_r), rtol=1e-4)
    cs_k, el_k = rcg_pallas.rcg_update(L, counts, 0.7, f32(v), 0.8, f32(0.9 * v))
    cs_r, el_r = rcg_xla.rcg_update(L, counts, f64(0.7), f64(v), f64(0.8), f64(0.9 * v))
    data, _ = rcg_xla.rcg_bound_stats(L, counts, f64(0.7), f64(v))
    np.testing.assert_allclose(np.asarray(cs_k), np.asarray(cs_r), rtol=1e-4,
                               atol=1e-4 * float(jnp.max(cs_r)))
    assert abs(float(el_k) - float(el_r)) <= 1e-6 * abs(float(data))
    zeros = jnp.zeros(L.shape[1], jnp.float32)
    lse, colsum, _ = em_pallas.em_step(L, counts[:, 0], jnp.zeros(E, jnp.float32),
                                       zeros, zeros)
    lse_r = jax.scipy.special.logsumexp(L.astype(jnp.float64), axis=1)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(lse_r), atol=1e-5)


@pytest.mark.parametrize("G", [512, 600])
def test_bootstrap_batch_matches_serial(gpu, G):
    """Bootstrap replicates run the Triton passes under jax.vmap: each
    replicate must follow its own unbatched fit (iterations within 10%,
    theta within 5e-6) and, over a fixed budget, the vmapped explicit
    step (theta within 1e-5)."""
    from test_pallas import _bootstrap_batch, _problem

    from msweep_tpu.inference.pack import DeviceProblem
    from msweep_tpu.inference.rcg import _state_theta, _run_rcg_arrays, fit_rcg_batch

    E = 8192 + 37
    logL, counts, alpha, bc = _problem(E=E, G=G, seed=7)
    prob = DeviceProblem(logL=logL, counts=counts, alpha=alpha, n_ecs=E, n_groups=G,
                         bound_const=bc, mesh=None)
    batch = jnp.asarray(_bootstrap_batch(counts, 3), jnp.float32)
    tb, ib, _ = fit_rcg_batch(prob, batch, tol=1e-6, max_iters=500)
    for b in range(3):
        st, _ = _run_rcg_arrays(logL, batch[b], alpha, bc, tol=1e-6, max_iters=500,
                                verbose=False, impl="pallas", refine=False)
        assert abs(int(ib[b]) - int(st.it)) <= max(5, int(st.it) // 10)
        np.testing.assert_allclose(np.asarray(tb[b]),
                                   np.asarray(_state_theta(st, batch[b], alpha)),
                                   rtol=0, atol=5e-6)
    fixed = dict(tol=-1.0, max_iters=20)
    t_k, _, _ = fit_rcg_batch(prob, batch, **fixed)
    t_x, _, _ = fit_rcg_batch(prob, batch, impl="xla", **fixed)
    np.testing.assert_allclose(np.asarray(t_k), np.asarray(t_x), rtol=0, atol=1e-5)


def test_gpu_dispatch_picks_kernels(gpu):
    from msweep_tpu.inference.rcg import choose_impl

    assert choose_impl(jnp.zeros((64, 512), jnp.float32))[0] == "pallas"
    assert choose_impl(jnp.zeros((64, 512), jnp.float64))[0] == "xla64"
