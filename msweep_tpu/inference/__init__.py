"""Inference engine (layer L5): the replacement for rcgpar.

The reference calls into the external rcgpar library
(rcg_optl_omp / rcg_optl_torch / em_torch / mixture_components,
src/mSWEEP.cpp:176-205,419-423).  Here the same three algorithm choices
exist as jitted JAX programs:

- ``rcg``  : Riemannian conjugate-gradient variational Bayes (msweep_tpu.inference.rcg)
- ``em``   : plain EM with Dirichlet-MAP M-step (msweep_tpu.inference.em)

Both run on the GPU or the CPU; the reference's rcgcpu/rcggpu split
collapses to one program (the CLI accepts all three names).
"""

from .pack import DeviceProblem, pack_problem
from .mixture import bound_const, mixture_components
from .rcg import fit_rcg, fit_rcg_result
from .em import fit_em, fit_em_result
from .rate import dirichlet_kld, dirichlet_kld_from_pseudocounts, rates_from_log_kld
from .result import FitResult

__all__ = [
    "DeviceProblem",
    "pack_problem",
    "bound_const",
    "mixture_components",
    "fit_rcg",
    "fit_rcg_result",
    "fit_em",
    "fit_em_result",
    "FitResult",
    "dirichlet_kld",
    "dirichlet_kld_from_pseudocounts",
    "rates_from_log_kld",
    "fit",
    "fit_result",
]


def _log_impl(log, name, problem) -> None:
    from .em import em_impl
    from .rcg import choose_impl

    impl, why = choose_impl(problem.logL, problem.mesh)
    if name == "em":
        impl = em_impl(impl)
    shards = problem.mesh.shape["ec"] if problem.mesh is not None else 1
    log(f"  {name} optimizer: impl={impl} ({why}) dtype={problem.logL.dtype} "
        f"ec_shards={shards}")


def fit(problem, algorithm="rcg", *, tol=1e-6, max_iters=5000, verbose=False, log=None):
    """Dispatch like the reference's rcg_optl wrapper (src/mSWEEP.cpp:176-205).

    Accepts reference algorithm names: rcgcpu/rcggpu -> rcg, emgpu -> em.
    Returns (gamma, n_iters, final_objective).  `log`, if given, receives
    one line naming the selected step implementation.
    """
    name = {"rcgcpu": "rcg", "rcggpu": "rcg", "emgpu": "em"}.get(algorithm, algorithm)
    if log is not None:
        _log_impl(log, name, problem)
    if name == "rcg":
        return fit_rcg(problem, tol=tol, max_iters=max_iters, verbose=verbose)
    if name == "em":
        return fit_em(problem, tol=tol, max_iters=max_iters, verbose=verbose)
    raise ValueError(f"unknown algorithm {algorithm}")


def fit_result(problem, algorithm="rcg", *, tol=1e-6, max_iters=5000, verbose=False,
               log=None, refine=True):
    """Like `fit` but returns a FitResult: theta/pseudocounts from the
    O(G) optimizer state, gamma materialized only via .gamma().  This is
    the CLI's dispatch — an abundances-only run never builds an (E, G)
    array beyond logL (the reference contract src/mSWEEP.cpp:419-423
    only consumes theta for `_abundances.txt`).  `refine` controls rcg
    precision escalation past the f32 floor (COMPAT.md section 7)."""
    name = {"rcgcpu": "rcg", "rcggpu": "rcg", "emgpu": "em"}.get(algorithm, algorithm)
    if log is not None:
        _log_impl(log, name, problem)
    if name == "rcg":
        return fit_rcg_result(
            problem, tol=tol, max_iters=max_iters, verbose=verbose, refine=refine
        )
    if name == "em":
        return fit_em_result(problem, tol=tol, max_iters=max_iters, verbose=verbose)
    raise ValueError(f"unknown algorithm {algorithm}")
