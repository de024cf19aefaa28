"""Plain EM with Dirichlet-MAP M-step (the "emgpu" algorithm).

Replacement for rcgpar::em_torch (call site src/mSWEEP.cpp:202).
Standard EM on the mixture (SURVEY.md section 3.4) [reconstructed: em_torch
source unavailable; this is the textbook algorithm its API implies]:

  E-step:  p_eg  proportional to theta_g * exp(L_eg), normalized per EC
  M-step:  theta_g proportional to max(alpha_g - 1 + sum_e c_e p_eg, 0)

Convergence when the MAP objective
  J = sum_e c_e logsumexp_g(L_eg + log theta_g) + sum_g (alpha_g-1) log theta_g
changes by less than tol.  With the default alpha=1 this is plain
maximum likelihood.  Like the reference's emgpu, the trajectory is
precision-sensitive (docs/gpubenchmarks.md:20-25).

Device structure mirrors rcg.py: lax.scan chunks with host convergence
checks between them, and the objective *change* is accumulated per row —
carrying the (E,) lse vector across iterations — as

  lse_e(theta) - lse_e(theta_prev) = log1p(sum_g p_prev_eg (r_g - 1))
                                   = log1p(sum_g exp(t_eg - lse_prev_e) q_g)

with r = theta / theta_prev, t = L + log theta and q = 1 - 1/r.  The
f32 rounding of this form is relative to the change itself, where a
difference of two f32 lse values carries an absolute error of about
|lse| * 6e-8 per row; so f32 runs resolve absolute tolerances far below
f32 resolution of the O(1e7) total objective.  Each iteration
makes ONE pass over logL (see _make_step: the deferred-delta scheme);
on the GPU with f32 matrices the pass is a fused Triton kernel
(ops/em_pallas.py) that reads the matrix exactly once per iteration.
"""

from __future__ import annotations

import sys
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import NEG, PAD_THRESHOLD
from .pack import DeviceProblem, acc_dtype


class EMState(NamedTuple):
    theta: jax.Array  # (G,) acc dtype
    lse: jax.Array  # (E,) per-row logsumexp at the PREVIOUS theta
    theta_prev: jax.Array  # (G,) acc dtype: the theta lse was taken at
    objective: jax.Array  # scalar (acc), running
    delta: jax.Array  # scalar, last objective change
    it: jax.Array
    done: jax.Array


def _safe_log(x, dtype):
    return jnp.where(x > 0, jnp.log(jnp.maximum(x, jnp.finfo(dtype).tiny)), jnp.asarray(NEG, dtype))


def _acc_dot(a, b):
    return jnp.sum((a * b).astype(acc_dtype()))


def _colsum_acc(x):
    E, G = x.shape
    B = 1024
    while E % B != 0:
        B //= 2
    if B <= 1:
        return jnp.sum(x.astype(acc_dtype()), axis=0)
    part = jnp.sum(x.reshape(E // B, B, G), axis=1)
    return jnp.sum(part.astype(acc_dtype()), axis=0)


def _estep(logL, theta, dtype):
    t = logL + _safe_log(theta, acc_dtype()).astype(dtype)[None, :]
    lse = jax.scipy.special.logsumexp(t, axis=1)
    return t, lse


def _make_kernels(mesh, interpret: bool):
    """Per-shard fused-kernel call with psum-merged sufficient statistics.

    With a mesh, runs under shard_map over the "ec" axis: each device
    reads only its EC shard of logL once and the G-sized colsum and the
    scalar objective-delta merge with psum — the same
    MPI-allreduce-shaped design as the rcg path (rcg._make_kernels,
    reference docs/compilation.md:40-58; em_torch is a first-class
    distributed algorithm at src/mSWEEP.cpp:202).
    """
    from ..ops import em_pallas

    def kernels(logL, counts, lse_prev, logtheta, q):
        lse, colsum, ddot = em_pallas.em_step(
            logL, counts, lse_prev, logtheta, q, interpret=interpret
        )
        if mesh is not None:
            colsum = jax.lax.psum(colsum, "ec")
            ddot = jax.lax.psum(ddot, "ec")
        return lse, colsum, ddot

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        rows = P("ec", None)
        vec = P("ec")
        rep = P()
        kernels = shard_map(
            kernels,
            mesh=mesh,
            in_specs=(rows, vec, vec, rep, rep),
            out_specs=(vec, rep, rep),
            check_vma=False,
        )
    return kernels


def _make_step(tol: float, valid, impl: str = "xla", mesh=None):
    """One EM iteration with ONE pass over logL (deferred-delta scheme).

    The convergence delta J(theta_k) - J(theta_{k-1}) is evaluated from
    this step's lse(theta_k) against the carried lse(theta_{k-1}) — the
    second E-step a naive implementation would spend purely on the
    convergence check is reused as the next iteration's E-step.  The
    check therefore fires one iteration after the naive formulation,
    with an identical delta sequence.
    """
    if impl != "xla":
        kernels = _make_kernels(mesh, interpret=(impl == "pallas_interpret"))

    def step(st: EMState, logL, counts, alpha):
        acc = acc_dtype()
        dtype = logL.dtype
        am1 = (alpha - 1.0).astype(acc)
        logtheta = _safe_log(st.theta, acc)
        log_prev = _safe_log(st.theta_prev, acc)
        # q = 1 - theta_prev / theta; 0 where theta is 0 (those groups
        # carry no responsibility at theta, and p_prev there underflowed).
        q = jnp.where(st.theta > 0, -jnp.expm1(log_prev - logtheta), 0.0)

        if impl == "xla":
            t, lse = _estep(logL, st.theta, dtype)
            p = jnp.exp(t - lse[:, None])
            nw = _colsum_acc(counts[:, None] * p)
            # sum_g exp(t - lse_prev) q = exp(lse - lse_prev) sum_g p q
            pq = jnp.sum(p * q.astype(dtype)[None, :], axis=1)
            data_delta = _acc_dot(counts, jnp.log1p(jnp.exp(lse - st.lse) * pq))
        else:  # pallas / pallas_interpret: fused single-read kernel
            lse, colsum, ddot = kernels(
                logL, counts, st.lse.astype(dtype), logtheta.astype(dtype), q.astype(dtype)
            )
            nw = colsum.astype(acc)
            data_delta = ddot.astype(acc)

        prior_delta = jnp.sum(jnp.where(valid, am1 * (logtheta - log_prev), 0.0))
        delta = data_delta + prior_delta
        first = st.it == 0
        # First step has no previous objective to compare against.
        delta = jnp.where(first, jnp.asarray(jnp.inf, acc), delta)
        obj_new = jnp.where(first, st.objective, st.objective + delta)

        raw = jnp.maximum(am1 + nw, 0.0)
        raw = jnp.where(valid, raw, 0.0)
        theta_new = raw / jnp.sum(raw)

        if tol < 0:
            done = jnp.zeros((), bool)
        else:
            done = ~first & (jnp.abs(delta) < tol)
        return EMState(
            theta=theta_new,
            lse=lse,
            theta_prev=st.theta,
            objective=obj_new,
            delta=delta,
            it=st.it + 1,
            done=st.done | done,
        )

    return step


def _print_chunk_history(it0: int, hist) -> None:
    """Host-side per-iteration diagnostics (see rcg._print_chunk_history)."""
    import numpy as np

    active, objs = (np.asarray(h) for h in hist)
    for k in range(len(active)):
        if not active[k]:
            break
        print(f"  iter {it0 + k + 1}  objective {objs[k]}", file=sys.stderr)


def _valid_mask(logL):
    return logL[0, :] > jnp.asarray(PAD_THRESHOLD, logL.dtype)


@jax.jit
def _em_init(logL, counts, alpha):
    acc = acc_dtype()
    dtype = logL.dtype
    valid = _valid_mask(logL)
    n_valid = jnp.sum(valid)
    theta0 = jnp.where(valid, 1.0 / n_valid, 0.0).astype(acc)
    _, lse0 = _estep(logL, theta0, dtype)
    am1 = (alpha - 1.0).astype(acc)
    obj0 = _acc_dot(counts, lse0) + jnp.sum(
        jnp.where(valid, am1 * _safe_log(theta0, acc), 0.0)
    )
    return EMState(
        theta=theta0,
        lse=lse0,
        theta_prev=theta0,
        objective=obj0,
        delta=jnp.asarray(jnp.inf, acc),
        it=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
    )


@partial(jax.jit, static_argnames=("length", "tol", "impl", "mesh"))
def _em_chunk(
    state, logL, counts, alpha, max_it=None, *, length: int, tol: float,
    impl: str = "xla", mesh=None,
):
    """Returns (state, history); history = (active, objective) per step,
    used for host-side verbose printing (see rcg._rcg_chunk).  `max_it`
    (dynamic) freezes states at the iteration cap so all chunks share
    one compiled scan length (see rcg._rcg_chunk)."""
    valid = _valid_mask(logL)
    step = _make_step(tol, valid, impl, mesh)

    def body(st, _):
        new = jax.lax.cond(st.done, lambda s: s, lambda s: step(s, logL, counts, alpha), st)
        if max_it is not None:
            new = new._replace(done=new.done | (new.it >= max_it))
        return new, (~st.done, new.objective)

    state, hist = jax.lax.scan(body, state, None, length=length)
    return state, hist


@jax.jit
def _em_final(logL, state):
    """Final responsibilities at the converged theta (the returned log
    probs matrix, same downstream handling as rcg: src/mSWEEP.cpp:419-423)."""
    t, lse = _estep(logL, state.theta, logL.dtype)
    return t - lse[:, None]


def em_impl(rcg_impl: str) -> str:
    """EM's step for the rcg implementation choose_impl picked: the fused
    kernel where rcg gets its kernel, the XLA step (any dtype) otherwise."""
    return rcg_impl if rcg_impl.startswith("pallas") else "xla"


def _run_em_arrays(logL, counts, alpha, *, tol, max_iters, verbose, chunk=16, impl=None, mesh=None):
    """Run the EM loop; returns the final state (theta lives in it)."""
    if impl is None:
        from .rcg import choose_impl

        impl = choose_impl(logL, mesh)[0]
    impl = em_impl(impl)
    kernel_mesh = mesh if impl.startswith("pallas") else None
    state = _em_init(logL, counts, alpha)
    max_it = jnp.asarray(max_iters, jnp.int32)
    it = 0
    while it < max_iters:
        state, hist = _em_chunk(
            state, logL, counts, alpha, max_it, length=chunk, tol=float(tol),
            impl=impl, mesh=kernel_mesh,
        )
        if verbose:
            _print_chunk_history(it, hist)
        it += chunk
        if tol >= 0 and bool(state.done):
            break
    return state


def _fit_em_arrays(logL, counts, alpha, *, tol, max_iters, verbose, chunk=16, impl=None, mesh=None):
    state = _run_em_arrays(
        logL, counts, alpha, tol=tol, max_iters=max_iters, verbose=verbose,
        chunk=chunk, impl=impl, mesh=mesh,
    )
    logp = _em_final(logL, state)
    return logp, state.it, state.objective


@jax.jit
def _em_state_pseudocounts(logL, theta, counts):
    """w_g = sum_e c_e p_eg at the converged theta: ONE fused streaming
    pass (the exp never materializes as a stored (E, G) array)."""
    t, lse = _estep(logL, theta, logL.dtype)
    return _colsum_acc(counts[:, None] * jnp.exp(t - lse[:, None]))


def fit_em(
    problem: DeviceProblem,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    verbose: bool = False,
    counts=None,
    chunk: int | None = None,
    impl: str | None = None,
):
    c = problem.counts if counts is None else counts
    if chunk is None:
        from .pack import auto_chunk

        chunk = auto_chunk(problem.logL)
    if impl is None:
        from .rcg import choose_impl

        impl = choose_impl(problem.logL, problem.mesh)[0]
    return _fit_em_arrays(
        problem.logL,
        c,
        problem.alpha,
        tol=float(tol),
        max_iters=int(max_iters),
        verbose=bool(verbose),
        chunk=chunk,
        impl=impl,
        mesh=problem.mesh if impl.startswith("pallas") else None,
    )


def fit_em_result(
    problem: DeviceProblem,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    verbose: bool = False,
    counts=None,
    chunk: int | None = None,
    impl: str | None = None,
):
    """Like fit_em but returns a FitResult (see rcg.fit_rcg_result):
    abundances via one fused pass, responsibilities only on demand."""
    from .result import FitResult

    c = problem.counts if counts is None else counts
    if chunk is None:
        from .pack import auto_chunk

        chunk = auto_chunk(problem.logL)
    if impl is None:
        from .rcg import choose_impl

        impl = choose_impl(problem.logL, problem.mesh)[0]
    state = _run_em_arrays(
        problem.logL,
        c,
        problem.alpha,
        tol=float(tol),
        max_iters=int(max_iters),
        verbose=bool(verbose),
        chunk=chunk,
        impl=impl,
        mesh=problem.mesh if impl.startswith("pallas") else None,
    )
    w = _em_state_pseudocounts(problem.logL, state.theta, c)
    theta = w / jnp.sum(c.astype(acc_dtype()))
    return FitResult(
        theta=theta,
        n_iters=state.it,
        objective=state.objective,
        pseudocounts=w,
        _gamma_fn=lambda: _em_final(problem.logL, state),
    )


@jax.jit
def _em_final_theta(logL, theta_b, counts_b):
    """Batched abundances sum_e c_e p_eg / sum_e c_e at the converged
    theta (rcgpar::mixture_components semantics, src/mSWEEP.cpp:420-423)
    without materializing the (B, E, G) responsibility batch — the exp
    fuses into the reduction."""

    def one(theta, counts):
        t, lse = _estep(logL, theta, logL.dtype)
        w = jnp.sum(counts[:, None] * jnp.exp(t - lse[:, None]), axis=0)
        return w.astype(acc_dtype()) / jnp.sum(counts).astype(acc_dtype())

    return jax.vmap(one)(theta_b, counts_b)


def fit_em_batch(problem: DeviceProblem, counts_batch, *, tol=1e-6, max_iters=5000, chunk=16):
    """EM over a (B, E_pad) batch of count vectors sharing one logL.
    Returns (theta (B, G_pad), iters (B,), objective (B,)) — matching
    fit_rcg_batch's interface (abundances, not responsibilities)."""
    init = jax.vmap(lambda c: _em_init(problem.logL, c, problem.alpha))
    state = init(counts_batch)
    max_it = jnp.asarray(max_iters, jnp.int32)
    it = 0
    while it < max_iters:
        state = jax.vmap(
            lambda st, c: _em_chunk(
                st, problem.logL, c, problem.alpha, max_it,
                length=chunk, tol=float(tol)
            )[0]
        )(state, counts_batch)
        it += chunk
        if bool(jnp.all(state.done)):
            break
    theta = _em_final_theta(problem.logL, state.theta, counts_batch)
    return theta, state.it, state.objective
