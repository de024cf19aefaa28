"""Riemannian conjugate-gradient variational Bayes (the "rcg" algorithm).

Replacement for rcgpar::rcg_optl_omp / rcg_optl_torch
(call sites src/mSWEEP.cpp:194-198).  rcgpar's source is not in the
reference snapshot (it is a FetchContent dependency), so this is a
from-scratch derivation of the published algorithm (Maklin et al. 2021,
Wellcome Open Res; Hensman et al. 2012/2015 natural-gradient conjugate
VB) matching the observed API contract (SURVEY.md section 3.3): inputs
(logL, ec counts, tol, max_iters), output log EC->group
probabilities, convergence when the ELBO improves by < tol.

Model and objective
-------------------
theta ~ Dirichlet(alpha); read e (multiplicity c_e) has component z_e with
log-likelihood L[e,g].  Mean-field q(Z)q(theta) with q(z_e)=Cat(exp gamma_e),
q(theta)=Dir(N), N = alpha + sum_e c_e exp(gamma_e).  With q(theta) kept
at its coordinate optimum the ELBO as a function of gamma alone is

    F(gamma) = bound_const + sum_g lgamma(N_g)
             + sum_e c_e sum_g exp(gamma_eg) (L_eg - gamma_eg)

(bound_const in mixture.bound_const; sum N is constant).

Iteration
---------
For conjugate-exponential mean-field models the *natural* gradient of F
w.r.t. the natural parameters of q(z_e) is (eta* - gamma), where
eta*_eg = L_eg + digamma(N_g) (row-normalized) is the exact VB
coordinate update.  The optimizer is nonlinear CG in that geometry:

    s      = rownorm(L + digamma(N)) - gamma      # natural gradient
    beta   = <s, s>_phi / <s_old, s_old>_phi      # Fletcher-Reeves,
                                                  # metric weight c_e*phi
    d      = s + beta * d_old
    gamma' = rownorm(gamma + d);  N' = alpha + sum_e c_e exp(gamma'_e)
    if F(gamma') < F(gamma): revert, reset d (next step is then the pure
    VB update gamma+s = eta*, which is monotone -> guaranteed recovery)

A beta=0 step is exactly VBEM, so the fixed points — and therefore the
converged abundances — coincide with the reference's optimizer even
though the step sequence need not.

Device structure (why this file looks the way it does)
------------------------------------------------------
1. Three implementations share the algorithm (choose_impl chooses):
   - "xla": the explicit (E, G)-state step above, verbatim — the
     independent semantic reference, and the CPU path.
   - "pallas": the IMPLICIT formulation (ops/rcg_pallas.py module
     docstring): gamma = rownorm(c * logL + v) for a scalar c and (G,)
     vector v, so the per-iteration state is O(G) and one iteration is
     two fused streaming passes over an f32 logL — 8 B/cell of device
     memory traffic, nothing else.  The GPU default for f32 matrices.
   - "xla64": the same implicit iteration as plain jnp in f64
     (ops/rcg_xla.py) — f64 matrices, and the precision-escalation tail.
   The trajectories agree to f32 round-off (tests/test_pallas.py).
2. Iterations run as `lax.scan` CHUNKS with a host-side convergence
   check between chunks: the host reads one flag per chunk, not one per
   iteration.  Converged states freeze inside a chunk (lax.cond
   pass-through) so per-iteration convergence semantics are exact.  The
   implicit step's scan carry is O(G), which keeps compile times flat.
3. The ELBO *change* is accumulated directly from elementwise
   differences (phi'(L-gamma') - phi(L-gamma), then row-sum, then an
   f64 scalar sum) instead of differencing two O(sum c * |L|) totals.
   At tol=1e-6 *absolute* on a bound of magnitude ~1e7, differencing
   would need ~1e-13 relative precision — i.e. full f64 passes over the
   matrix, at twice the bytes of f32.  Differences of nearly-equal
   intermediates cancel rounding to first order, so f32 matrices
   converge at reference tolerances.
4. Long-axis reductions are two-stage: f32 inside rows / row-blocks /
   kernel programs, f64 across (see _rowsum_acc/_colsum_acc).  The
   G-sized state (N, digamma, lgamma, and the implicit (c, v, e, f)) is
   carried in f64 — tiny, and it keeps the Dirichlet terms of the bound
   exact.

Shapes: logL (E, G), counts (E,), alpha (G,); padding per inference.pack
is inert.  tol < 0 is bench mode: run exactly max_iters iterations.
"""

from __future__ import annotations

import sys
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

from ..utils import PAD_THRESHOLD
from .pack import DeviceProblem, acc_dtype


class RCGState(NamedTuple):
    """Explicit-state ("xla" impl) per-iteration state."""

    gamma: jax.Array  # (E, G) log q(z)
    d: jax.Array  # (E, G) conjugate direction
    n_counts: jax.Array  # (G,) Dirichlet posterior counts N (acc dtype)
    oldnorm: jax.Array  # scalar, previous metric norm (acc)
    bound: jax.Array  # scalar ELBO, running (acc)
    delta: jax.Array  # scalar, last accepted improvement (acc)
    it: jax.Array  # int32 iterations executed
    done: jax.Array  # bool
    just_reset: jax.Array  # bool, momentum was reset last step


class RCGImplicitState(NamedTuple):
    """Implicit-state ("pallas" impl): gamma = rownorm(c*logL + v), the
    direction d = e*logL + f modulo row constants (which never matter
    for d — see ops/rcg_pallas.py).  Everything is O(G)."""

    c: jax.Array  # scalar (acc)
    v: jax.Array  # (G,) (acc)
    e: jax.Array  # scalar (acc): direction coefficient
    f: jax.Array  # (G,) (acc): direction vector part
    n_counts: jax.Array  # (G,) (acc)
    oldnorm: jax.Array  # scalar (acc)
    bound: jax.Array  # scalar (acc)
    delta: jax.Array  # scalar (acc)
    it: jax.Array  # int32
    done: jax.Array  # bool
    just_reset: jax.Array  # bool


def _rownorm(x):
    return x - jax.scipy.special.logsumexp(x, axis=-1, keepdims=True)


def _rowsum_acc(x):
    """Sum (E, G) -> scalar: f32 row sums, f64 across rows."""
    return jnp.sum(jnp.sum(x, axis=1).astype(acc_dtype()))


def _colsum_acc(x):
    """Sum (E, G) -> (G,): f32 within row blocks, f64 across blocks.

    Keeps the f64 work at O(E/B * G) elements instead of O(E * G).
    """
    E, G = x.shape
    B = 1024
    while E % B != 0:
        B //= 2
    if B <= 1:
        return jnp.sum(x.astype(acc_dtype()), axis=0)
    part = jnp.sum(x.reshape(E // B, B, G), axis=1)
    return jnp.sum(part.astype(acc_dtype()), axis=0)


def _weighted_colsum(w_phi):
    return _colsum_acc(w_phi)


def _converged(tol, delta, decreased, just_reset):
    """Converged: accepted step with 0 <= improvement < tol, or a pure
    VB step that still "decreased" (numerical floor).  tol < 0 is
    bench mode: never converge.  Shape-polymorphic: scalar for the
    single fit, (B,) for the batched bootstrap fit."""
    if tol < 0:
        return jnp.zeros(jnp.shape(delta), bool)
    return (~decreased & (delta < tol)) | (decreased & just_reset)


def _make_step(tol: float):
    """The explicit XLA step (semantic reference)."""

    def step(st: RCGState, logL, counts, alpha):
        acc = acc_dtype()
        dtype = logL.dtype

        psi_n = digamma(st.n_counts).astype(dtype)
        eta = _rownorm(logL + psi_n[None, :])
        s = eta - st.gamma

        phi_old = jnp.exp(st.gamma)
        w_old = counts[:, None] * phi_old
        newnorm = _rowsum_acc(w_old * s * s)
        beta_fr = jnp.where(
            st.just_reset | (st.it == 0) | (st.oldnorm <= 0),
            jnp.zeros((), acc),
            newnorm / st.oldnorm,
        ).astype(dtype)

        d_new = s + beta_fr * st.d
        gamma_new = _rownorm(st.gamma + d_new)
        phi_new = jnp.exp(gamma_new)
        w_new = counts[:, None] * phi_new

        # ELBO change, elementwise-difference-first (see module docstring).
        data_diff = w_new * (logL - gamma_new) - w_old * (logL - st.gamma)
        elbo_delta = _rowsum_acc(data_diff)
        n_new = alpha.astype(acc) + _weighted_colsum(w_new)
        dirichlet_delta = jnp.sum(gammaln(n_new) - gammaln(st.n_counts))
        delta = elbo_delta + dirichlet_delta
        bound_new = st.bound + delta

        acc_ = acc_dtype()
        decreased = delta < 0
        newly_done = _converged(tol, delta, decreased, st.just_reset)

        # On revert, d keeps its stale value: just_reset forces beta=0 on
        # the next step, so it is never read before being rewritten.  The
        # revert is a rare numerical-floor event, so it is a lax.cond:
        # the accepted path passes buffers through instead of paying
        # full-matrix selects every iteration.
        gamma_out, d_out, n_out, norm_out, bound_out, delta_out = jax.lax.cond(
            decreased,
            lambda: (st.gamma, st.d, st.n_counts, jnp.ones((), acc_), st.bound, st.delta),
            lambda: (gamma_new, d_new, n_new, newnorm, bound_new, delta),
        )
        return RCGState(
            gamma=gamma_out,
            d=d_out,
            n_counts=n_out,
            oldnorm=norm_out,
            bound=bound_out,
            delta=delta_out,
            it=st.it + 1,
            done=st.done | newly_done,
            just_reset=decreased,
        )

    return step


def _make_kernels(mesh, impl: str):
    """The fused pair of passes for one implicit iteration.

    "pallas" / "pallas_interpret" run the Triton kernels
    (ops/rcg_pallas.py); "xla64" runs the jnp twins (ops/rcg_xla.py) in
    f64 — f64 matrices and the precision-escalation tail.

    With a mesh, the passes run under shard_map over the "ec" axis: each
    device streams its EC shard and the G-sized sufficient statistics
    (newnorm, colsum, ELBO delta) merge with psum — the collective form
    of the reference's MPI-allreduce design (docs/compilation.md:40-58).
    No per-row state crosses passes: the update pass recomputes the old
    data term in-stream (dual softmax), so everything merged is O(G).
    """
    if impl == "xla64":
        from ..ops import rcg_xla as M

        kern_norm, kern_update = M.rcg_norm, M.rcg_update
    else:
        from ..ops import rcg_pallas as M

        interpret = impl == "pallas_interpret"
        kern_norm = partial(M.rcg_norm, interpret=interpret)
        kern_update = partial(M.rcg_update, interpret=interpret)

    acc = acc_dtype()

    def norm_pass(logL, counts2d, psi, c, v):
        newnorm = kern_norm(logL, counts2d, psi, c, v).astype(acc)
        if mesh is not None:
            newnorm = jax.lax.psum(newnorm, "ec")
        return newnorm

    def update_pass(logL, counts2d, c_old, v_old, c_new, v_new):
        colsum, elbo_raw = kern_update(
            logL, counts2d, c_old, v_old, c_new, v_new
        )
        colsum = colsum.astype(acc)
        elbo_delta = elbo_raw.astype(acc)
        if mesh is not None:
            colsum = jax.lax.psum(colsum, "ec")
            elbo_delta = jax.lax.psum(elbo_delta, "ec")
        return colsum, elbo_delta

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        ec = P("ec", None)
        rep = P()
        norm_pass = shard_map(
            norm_pass, mesh=mesh,
            in_specs=(ec, ec, rep, rep, rep),
            out_specs=rep,
            check_vma=False,
        )
        update_pass = shard_map(
            update_pass, mesh=mesh,
            in_specs=(ec, ec, rep, rep, rep, rep),
            out_specs=(rep, rep),
            check_vma=False,
        )
    return norm_pass, update_pass


def _make_bound_eval(mesh):
    """Exact-f64 ELBO statistics at gamma = (c, v): ONE blocked pass
    (ops/rcg_xla.rcg_bound_stats), psum-merged under a mesh.  The blind
    escalation tail's convergence supervisor."""
    from ..ops import rcg_xla

    def eval_(logL, counts2d, c, v):
        data, colsum = rcg_xla.rcg_bound_stats(logL, counts2d, c, v)
        if mesh is not None:
            data = jax.lax.psum(data, "ec")
            colsum = jax.lax.psum(colsum, "ec")
        return data, colsum

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        eval_ = shard_map(
            eval_, mesh=mesh,
            in_specs=(P("ec", None), P("ec", None), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
    return eval_


def _make_step_implicit(tol: float, impl: str, mesh=None, blind_tau=None):
    """One implicit iteration: two streaming passes + O(G) coefficient
    recursion (see ops/rcg_pallas.py for the derivation).  With "xla64"
    the passes run in f64 (precision-escalation tail) while logL stays
    in its compact dtype.

    `blind_tau` (traced scalar) puts the step in BLIND mode for the
    fast escalation tail: the f32 delta estimate is pure noise there,
    so the step never declares convergence itself (an f64 supervisor
    does, see _run_rcg_arrays) and reverts only on decreases larger
    than tau — the measured noise scale — so noise-positive/negative
    jitter no longer stalls the iterate the way the strict
    revert-on-any-decrease rule does at the floor."""
    acc = acc_dtype()
    norm_pass, update_pass = _make_kernels(mesh, impl)

    def step(st: RCGImplicitState, logL, counts2d, alpha):
        dtype = acc if impl == "xla64" else logL.dtype
        psi = digamma(st.n_counts)
        psi32 = psi.astype(dtype)[None, :]
        c32 = st.c.astype(dtype)
        v32 = st.v.astype(dtype)[None, :]

        newnorm = norm_pass(logL, counts2d, psi32, c32, v32)
        beta = jnp.where(
            st.just_reset | (st.it == 0) | (st.oldnorm <= 0),
            jnp.zeros((), acc),
            newnorm / st.oldnorm,
        )

        # Affine direction recursion (exact-arithmetic equivalent of
        # d_new = s + beta*d; see ops/rcg_pallas.py module docstring).
        e_new = (1.0 - st.c) + beta * st.e
        f_new = (psi - st.v) + beta * st.f
        c_new = st.c + e_new
        v_new = st.v + f_new

        colsum, elbo_delta = update_pass(
            logL, counts2d, c32, v32,
            c_new.astype(dtype), v_new.astype(dtype)[None, :],
        )
        n_new = alpha.astype(acc) + colsum
        dirichlet_delta = jnp.sum(gammaln(n_new) - gammaln(st.n_counts))
        delta = elbo_delta + dirichlet_delta
        bound_new = st.bound + delta

        if blind_tau is not None:
            decreased = delta < -blind_tau
            newly_done = jnp.zeros((), bool)  # supervisor decides
        else:
            decreased = delta < 0
            newly_done = _converged(tol, delta, decreased, st.just_reset)

        # Accept/revert on O(G) state: effectively free, unlike the
        # explicit impl's full-matrix cond.  On revert (e, f) keep stale
        # values — just_reset forces beta=0 next step, so they are
        # rewritten before being read.
        c_o, v_o, e_o, f_o, n_o, norm_o, bound_o, delta_o = jax.lax.cond(
            decreased,
            lambda: (st.c, st.v, st.e, st.f, st.n_counts,
                     jnp.ones((), acc), st.bound, st.delta),
            lambda: (c_new, v_new, e_new, f_new, n_new, newnorm, bound_new, delta),
        )
        return RCGImplicitState(
            c=c_o, v=v_o, e=e_o, f=f_o, n_counts=n_o, oldnorm=norm_o,
            bound=bound_o, delta=delta_o, it=st.it + 1,
            done=st.done | newly_done, just_reset=decreased,
        )

    return step


@jax.jit
def _rcg_init(logL, counts, alpha, bc):
    acc = acc_dtype()
    dtype = logL.dtype
    # gamma_0 = log(1/G) on real groups; NEG-ish on padded groups so their
    # softmax weight is 0 from the start.  In implicit form this is
    # exactly (c, v) = (0, 0) under the kernels' pad masking.
    init_logits = jnp.where(logL > jnp.asarray(PAD_THRESHOLD, dtype), 0.0, logL)
    gamma0 = _rownorm(init_logits)
    w0 = counts[:, None] * jnp.exp(gamma0)
    n0 = alpha.astype(acc) + _weighted_colsum(w0)
    # Exact initial bound (one full evaluation; all later bounds accumulate
    # deltas on top of this f64 scalar).
    bound0 = (
        jnp.asarray(bc, acc)
        + jnp.sum(gammaln(n0))
        + _rowsum_acc(w0 * (logL - gamma0))
    )
    return RCGState(
        gamma=gamma0,
        # d starts at zeros; the first step runs with beta=0 (no momentum),
        # so this slot is inert until first written.
        d=jnp.zeros_like(gamma0),
        n_counts=n0,
        oldnorm=jnp.ones((), acc),
        bound=bound0,
        delta=jnp.asarray(jnp.inf, acc),
        it=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        just_reset=jnp.zeros((), bool),
    )


@jax.jit
def _rcg_init_implicit(logL, counts, alpha, bc):
    """Implicit init: no (E, G) state.  N_0 and the exact initial bound
    are computed with ONE row-blocked streaming pass (gamma_0 is
    uniform over real groups, masked on padded ones — the same values
    the kernels reconstruct from (c, v) = (0, 0)).

    The blocking matters for capacity: delegating to the explicit
    _rcg_init lets XLA materialize ~2 extra (E, G) init temporaries;
    streaming the init keeps the device working set at logL itself."""
    acc = acc_dtype()
    E, G = logL.shape
    if E * G < (1 << 27):
        # Small problems (and every sharded test mesh) keep the fused
        # whole-matrix init: the reshaped scan below can fight GSPMD
        # sharding propagation, and the temporaries are tiny here.
        st0 = _rcg_init(logL, counts, alpha, bc)
        return RCGImplicitState(
            c=jnp.zeros((), acc),
            v=jnp.zeros((G,), acc),
            e=jnp.zeros((), acc),
            f=jnp.zeros((G,), acc),
            n_counts=st0.n_counts,
            oldnorm=jnp.ones((), acc),
            bound=st0.bound,
            delta=jnp.asarray(jnp.inf, acc),
            it=jnp.zeros((), jnp.int32),
            done=jnp.zeros((), bool),
            just_reset=jnp.zeros((), bool),
        )
    from ..ops.rcg_xla import _pick_block

    b = _pick_block(E)
    Lb = logL.reshape(E // b, b, G)
    cb = counts.reshape(E // b, b)
    pad = jnp.asarray(PAD_THRESHOLD, logL.dtype)

    def body(carry, xs):
        colsum, data = carry
        Lblk, cblk = xs
        init_logits = jnp.where(Lblk > pad, 0.0, Lblk)
        g0 = _rownorm(init_logits)
        w0 = cblk[:, None] * jnp.exp(g0)
        colsum = colsum + jnp.sum(w0, axis=0).astype(acc)
        data = data + jnp.sum(jnp.sum(w0 * (Lblk - g0), axis=1).astype(acc))
        return (colsum, data), None

    (colsum, data), _ = jax.lax.scan(
        body, (jnp.zeros((G,), acc), jnp.zeros((), acc)), (Lb, cb)
    )
    n0 = alpha.astype(acc) + colsum
    bound0 = jnp.asarray(bc, acc) + jnp.sum(gammaln(n0)) + data
    return RCGImplicitState(
        c=jnp.zeros((), acc),
        v=jnp.zeros((G,), acc),
        e=jnp.zeros((), acc),
        f=jnp.zeros((G,), acc),
        n_counts=n0,
        oldnorm=jnp.ones((), acc),
        bound=bound0,
        delta=jnp.asarray(jnp.inf, acc),
        it=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        just_reset=jnp.zeros((), bool),
    )


# Implementations that carry the O(G) implicit state (RCGImplicitState).
IMPLICIT = ("pallas", "pallas_interpret", "xla64")


def choose_impl(logL, mesh=None) -> tuple[str, str]:
    """(impl, why) for a problem; never an interpret-mode impl.

    On the GPU: the fused Triton passes ("pallas") for f32 matrices —
    single card or an "ec"-axis mesh (shard_map + psum) — and the
    implicit f64 step ("xla64") for f64 matrices or rows wider than the
    kernel holds.  The explicit step ("xla") everywhere else: it is the
    CPU test reference, and the path for meshes other than ("ec",)."""
    from ..ops import rcg_pallas

    if jax.default_backend() != "gpu":
        return "xla", f"explicit reference step on {jax.default_backend()}"
    if mesh is not None and tuple(mesh.axis_names) != ("ec",):
        return "xla", f"mesh axes {tuple(mesh.axis_names)} are not ('ec',)"
    if logL.dtype == jnp.float64:
        return "xla64", "float64 matrix"
    if rcg_pallas.supports(logL):
        return "pallas", "fused Triton passes"
    return "xla64", f"no fused kernel for {logL.dtype} width {logL.shape[-1]}"


def _guarded_step(step, st, *args):
    """Freeze converged states: cond pass-through, not a full select."""
    return jax.lax.cond(st.done, lambda s: s, lambda s: step(s, *args), st)


@partial(jax.jit, static_argnames=("length", "tol", "impl", "mesh"))
def _rcg_chunk(
    state, logL, counts, alpha, max_it=None, blind_tau=None, *, length: int,
    tol: float, impl: str = "xla", mesh=None,
):
    """length iterations as one on-device lax.scan.

    Returns (state, history) where history = (active, bound, reset) per
    scan step — tiny (length,) vectors the host uses for verbose
    diagnostics, read once per chunk.  Frozen (converged) steps have
    active=False.

    `max_it` (dynamic int32, optional) freezes the state once it
    reaches that iteration count: the host loop always scans the SAME
    static `length`, so every chunk — including the final partial one —
    hits one jit cache entry (a distinct final length used to cost a
    full recompile per distinct max_iters).
    """
    if impl in IMPLICIT:
        step = _make_step_implicit(tol, impl, mesh=mesh, blind_tau=blind_tau)
        args = (logL, counts[:, None].astype(logL.dtype), alpha)
    else:
        step = _make_step(tol)
        args = (logL, counts, alpha)

    def body(st, _):
        new = _guarded_step(step, st, *args)
        if max_it is not None:
            new = new._replace(done=new.done | (new.it >= max_it))
        return new, (~st.done, new.bound, new.just_reset)

    state, hist = jax.lax.scan(body, state, None, length=length)
    return state, hist


def _run_rcg_arrays(
    logL,
    counts,
    alpha,
    bc,
    *,
    tol: float,
    max_iters: int,
    verbose: bool,
    chunk: int = 16,
    impl: str | None = None,
    mesh=None,
    refine: bool = True,
):
    """Run the optimizer loop; returns (final state, implicit: bool).

    The state is O(G) on the implicit path — callers that only need
    abundances (the reference's plain `_abundances.txt` run,
    src/mSWEEP.cpp:419-423) never touch an (E, G) array beyond logL.

    PRECISION ESCALATION (`refine`, default on): the f32 kernel path
    stops either at true tol convergence or at its numerical floor —
    per-iteration ELBO deltas below the f32 row-differencing noise
    (~1e-3 absolute at reference scale) are unobservable, which fires
    the `decreased & just_reset` branch of _converged with the last
    accepted delta still above tol.  When that happens, the SAME
    implicit O(G) iteration continues with f64 arithmetic
    (ops/rcg_xla.py; logL stays f32 and upcasts in-stream) until the
    true tol.  On reference-conditioned problems the floor stop leaves
    theta off by ~1e-3; only the tail pays f64 cost.
    """
    if impl is None:
        impl = choose_impl(logL, mesh)[0]
    implicit = impl in IMPLICIT
    if implicit:
        state = _rcg_init_implicit(logL, counts, alpha, bc)
    else:
        state = _rcg_init(logL, counts, alpha, bc)
    # Fixed-length chunks with a DYNAMIC iteration cap: every chunk —
    # including the final partial one — reuses one compiled scan (the
    # cap freezes states at max_iters inside the chunk).
    max_it = jnp.asarray(max_iters, jnp.int32)
    it = 0
    while it < max_iters:
        state, hist = _rcg_chunk(
            state, logL, counts, alpha, max_it, length=chunk, tol=float(tol),
            impl=impl,
            mesh=mesh if implicit else None,
        )
        if verbose:
            _print_chunk_history(it, hist)
        it += chunk
        if tol >= 0 and bool(state.done):
            break

    if (
        refine
        and tol >= 0
        and impl in ("pallas", "pallas_interpret")
        and acc_dtype() == jnp.float64  # escalation needs x64 enabled
        and bool(state.done)
        and not (0 <= float(state.delta) < tol)  # floor stop, not true tol
    ):
        state, it = _escalate(
            state, logL, counts, alpha, bc, it=it, max_it=max_it,
            max_iters=max_iters, tol=float(tol), chunk=chunk, impl=impl,
            mesh=mesh, verbose=verbose, exact=(refine == "exact"),
        )
    return state, implicit


def _escalate(
    state, logL, counts, alpha, bc, *, it, max_it, max_iters, tol, chunk,
    impl, mesh, verbose, exact=False,
):
    """Past-the-floor refinement to honest f64 convergence.

    Default ("fast"): BLIND f32 chunks supervised by periodic exact-f64
    ELBO evaluations.  Past the floor the f32 iterate map is still
    accurate (its output noise in theta terms is ~1e-10 — only the
    DELTA estimate is noise), so the tail runs the cheap f32 kernels
    with revert thresholded at the measured noise scale and no
    self-stopping; every `chunk` iterations one f64 pass computes the
    exact bound, and the fit stops when the supervised per-iteration
    improvement drops below tol.  If a supervision window ever shows a
    net DECREASE (blind CG went unstable — not observed in practice),
    the window is rolled back and the tail falls back to full-f64
    stepping (`exact=True` path), the all-double formulation.  The fast
    tail costs f32 iterations plus one f64 pass per window.
    """
    acc = acc_dtype()
    if verbose:
        print(
            f"  f32 numerical floor at iter {int(state.it)} "
            f"(last accepted delta {float(state.delta):.3e}); escalating "
            f"({'exact-f64 tail' if exact else 'blind-f32 tail, f64 supervision'})",
            file=sys.stderr,
        )
    counts2d = counts[:, None].astype(logL.dtype)
    bound_eval = _make_bound_eval(mesh)

    def exact_stats(st):
        data, colsum = bound_eval(logL, counts2d, st.c, st.v)
        n64 = alpha.astype(acc) + colsum
        bound = jnp.asarray(bc, acc) + jnp.sum(gammaln(n64)) + data
        return bound, n64

    # Re-anchor in f64: the f32-era n_counts carries ~1e-7-relative
    # rounding which, through lgamma at N ~ 1e4, injects O(1) spurious
    # deltas — enough to make the first honest f64 step look like a
    # decrease and re-fire the floor stop.
    bound0, n64 = exact_stats(state)
    state = state._replace(
        n_counts=n64,
        bound=bound0,
        done=jnp.zeros((), bool),
        just_reset=jnp.ones((), bool),  # restart momentum cleanly
        oldnorm=jnp.ones((), acc),
    )

    if not exact:
        d0 = float(state.delta)
        import math

        tau = jnp.asarray(
            4.0 * abs(d0) if math.isfinite(d0) else 0.0, acc
        )
        bound_prev = float(bound0)
        while it < max_iters:
            ckpt = state
            prev_it = int(state.it)
            state, hist = _rcg_chunk(
                state, logL, counts, alpha, max_it, tau, length=chunk,
                tol=tol, impl=impl, mesh=mesh,
            )
            if verbose:
                _print_chunk_history(it, hist)
            it += chunk
            steps = int(state.it) - prev_it
            if steps == 0:
                break  # max_it freeze
            bound_now_arr, n64 = exact_stats(state)
            bound_now = float(bound_now_arr)
            davg = (bound_now - bound_prev) / steps
            if bound_now < bound_prev:
                # blind window went downhill: roll back, go exact
                state = ckpt
                it -= chunk
                if verbose:
                    print(
                        f"  blind window decreased the bound by "
                        f"{bound_prev - bound_now:.3e}; falling back to "
                        "exact f64 stepping",
                        file=sys.stderr,
                    )
                break
            state = state._replace(
                n_counts=n64, bound=bound_now_arr,
                delta=jnp.asarray(davg, acc),
            )
            if verbose:
                print(
                    f"  iter {int(state.it)}  f64 bound {bound_now}  "
                    f"(avg delta/iter {davg:.3e})",
                    file=sys.stderr,
                )
            if davg < tol:
                # Blind phase done — fall through to a short exact-f64
                # POLISH: the blind iterate inherits a small fixed-point
                # bias from f32 psi noise (~1e-5 in theta); the exact
                # tail below applies the true per-iteration criterion
                # and typically fires within a few windows.
                break
            bound_prev = bound_now
        if bool(state.done) or it >= max_iters:
            return state, it
        # exact-f64 tail: polish after blind convergence, or full
        # fallback after a rollback.  Momentum resets here: carrying the
        # blind phase's noisy CG direction into the exact tail was
        # measured to COST ~10% more iterations and 2x the polish time,
        # not save it.
        state = state._replace(
            just_reset=jnp.ones((), bool), oldnorm=jnp.ones((), acc)
        )

    # The exact tail's first chunk may not stop (blind_tau = 0: strict
    # revert, no self-stop).  Stopping on its first, momentum-free step
    # ends the fit wherever the blind phase left it: ~3e-6 from the
    # optimum in theta on the synth test problem, ~1.3e-6 after one
    # chunk of CG steps.
    tau = jnp.zeros((), acc)
    while it < max_iters:
        state, hist = _rcg_chunk(
            state, logL, counts, alpha, max_it, tau, length=chunk,
            tol=tol, impl="xla64", mesh=mesh,
        )
        tau = None
        if verbose:
            _print_chunk_history(it, hist)
        it += chunk
        if bool(state.done):
            break
    return state, it


def _state_gamma(logL, state, implicit: bool):
    """Materialize the (E, G) log-probability matrix from a final state
    (ONE streaming pass on the implicit path; free on the explicit one)."""
    if implicit:
        from ..ops import rcg_xla

        return rcg_xla.materialize_gamma(
            logL, state.c.astype(logL.dtype), state.v.astype(logL.dtype)
        )
    return state.gamma


def _state_theta(state, counts, alpha):
    """Abundances straight from optimizer state: theta = (N - alpha)/sum c.

    By the definition of the Dirichlet posterior counts
    N = alpha + sum_e c_e exp(gamma_e), this equals
    rcgpar::mixture_components of the converged gamma
    (src/mSWEEP.cpp:420) without materializing gamma — O(G) work."""
    acc = acc_dtype()
    csum = jnp.sum(counts.astype(acc))
    return (state.n_counts - alpha.astype(acc)) / csum


def _fit_rcg_arrays(
    logL,
    counts,
    alpha,
    bc,
    *,
    tol: float,
    max_iters: int,
    verbose: bool,
    chunk: int = 16,
    impl: str | None = None,
    mesh=None,
    refine: bool = True,
):
    state, implicit = _run_rcg_arrays(
        logL, counts, alpha, bc, tol=tol, max_iters=max_iters,
        verbose=verbose, chunk=chunk, impl=impl, mesh=mesh, refine=refine,
    )
    return _state_gamma(logL, state, implicit), state.it, state.bound


def _print_chunk_history(it0: int, hist) -> None:
    """Host-side per-iteration diagnostics from a chunk's history
    (active steps form a prefix: convergence freezes the scan state)."""
    import numpy as np

    active, bounds, resets = (np.asarray(h) for h in hist)
    for k in range(len(active)):
        if not active[k]:
            break
        print(
            f"  iter {it0 + k + 1}  bound {bounds[k]}  (reset={bool(resets[k])})",
            file=sys.stderr,
        )


def fit_rcg(
    problem: DeviceProblem,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    verbose: bool = False,
    counts=None,
    chunk: int | None = None,
    impl: str | None = None,
    refine: bool = True,
):
    """Run rcg on a packed problem. Returns (gamma, n_iters, bound).

    `gamma` keeps the padded (E_pad, G_pad) shape (slice with
    problem.n_ecs/n_groups when materializing outputs); `counts`
    optionally overrides problem.counts (bootstrap replicates).
    `impl` None = auto (choose_impl): on the GPU the fused Triton passes
    (shard_map + psum on an "ec" mesh) with f64 escalation past the f32
    floor (`refine`) and the implicit f64 step for double matrices; the
    explicit step on the CPU.
    """
    c = problem.counts if counts is None else counts
    if chunk is None:
        from .pack import auto_chunk

        chunk = auto_chunk(problem.logL)
    if impl is None:
        impl = choose_impl(problem.logL, problem.mesh)[0]
    return _fit_rcg_arrays(
        problem.logL,
        c,
        problem.alpha,
        problem.bound_const,
        tol=float(tol),
        max_iters=int(max_iters),
        verbose=bool(verbose),
        chunk=chunk,
        impl=impl,
        mesh=problem.mesh if impl != "xla" else None,
        refine=refine,
    )


def fit_rcg_result(
    problem: DeviceProblem,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    verbose: bool = False,
    counts=None,
    chunk: int | None = None,
    impl: str | None = None,
    refine: bool = True,
):
    """Like fit_rcg but returns a FitResult: abundances and pseudocounts
    from the O(G) optimizer state, gamma materialized only on demand.

    This is the CLI's path — an abundances-only run at reference scale
    (E=2.3M x G=512) allocates nothing bigger than logL itself."""
    from .result import FitResult

    c = problem.counts if counts is None else counts
    if chunk is None:
        from .pack import auto_chunk

        chunk = auto_chunk(problem.logL)
    if impl is None:
        impl = choose_impl(problem.logL, problem.mesh)[0]
    state, implicit = _run_rcg_arrays(
        problem.logL,
        c,
        problem.alpha,
        problem.bound_const,
        tol=float(tol),
        max_iters=int(max_iters),
        verbose=bool(verbose),
        chunk=chunk,
        impl=impl,
        mesh=problem.mesh if impl != "xla" else None,
        refine=refine,
    )
    theta = _state_theta(state, c, problem.alpha)
    return FitResult(
        theta=theta,
        n_iters=state.it,
        objective=state.bound,
        pseudocounts=state.n_counts - problem.alpha.astype(acc_dtype()),
        _gamma_fn=lambda: _state_gamma(problem.logL, state, implicit),
    )


# ---------------------------------------------------------------------------
# Batched (bootstrap) fit: B count vectors over one logL.
# ---------------------------------------------------------------------------


def _make_step_implicit_batch(tol: float, impl: str, mesh=None):
    """Batched implicit iteration: all state fields carry a leading (B,)
    replicate axis; the single-replicate passes run under jax.vmap over
    it; accept/revert is per-replicate jnp.where (the revert is no
    longer rare across a whole batch, and the state is O(B*G))."""
    acc = acc_dtype()
    norm_pass, update_pass = _make_kernels(mesh, impl)
    norm_pass = jax.vmap(norm_pass, in_axes=(None, 0, 0, 0, 0))
    update_pass = jax.vmap(update_pass, in_axes=(None, 0, 0, 0, 0, 0))

    def step(st: RCGImplicitState, logL, counts_b, alpha):
        dtype = acc if impl == "xla64" else logL.dtype
        psi = digamma(st.n_counts)  # (B, G)
        c_old, v_old = st.c.astype(dtype), st.v.astype(dtype)[:, None, :]

        newnorm = norm_pass(logL, counts_b, psi.astype(dtype)[:, None, :],
                            c_old, v_old)
        beta = jnp.where(
            st.just_reset | (st.it == 0) | (st.oldnorm <= 0),
            jnp.zeros_like(newnorm),
            newnorm / st.oldnorm,
        )

        e_new = (1.0 - st.c) + beta * st.e
        f_new = (psi - st.v) + beta[:, None] * st.f
        c_new = st.c + e_new
        v_new = st.v + f_new

        colsum, elbo_delta = update_pass(
            logL, counts_b, c_old, v_old,
            c_new.astype(dtype), v_new.astype(dtype)[:, None, :],
        )
        n_new = alpha[None, :].astype(acc) + colsum
        dirichlet_delta = jnp.sum(gammaln(n_new) - gammaln(st.n_counts), axis=1)
        delta = elbo_delta + dirichlet_delta
        bound_new = st.bound + delta

        decreased = delta < 0
        newly_done = _converged(tol, delta, decreased, st.just_reset)

        def rev(old, new):
            m = decreased
            while m.ndim < new.ndim:
                m = m[..., None]
            return jnp.where(m, old, new)

        return RCGImplicitState(
            c=rev(st.c, c_new), v=rev(st.v, v_new),
            e=rev(st.e, e_new), f=rev(st.f, f_new),
            n_counts=rev(st.n_counts, n_new),
            oldnorm=jnp.where(decreased, jnp.ones_like(newnorm), newnorm),
            bound=rev(st.bound, bound_new), delta=rev(st.delta, delta),
            it=st.it + 1, done=st.done | newly_done, just_reset=decreased,
        )

    return step


def _contract_counts(counts_b, x):
    """sum_e counts_b[b, e] x[e, ...] as (B, ...) in the accumulation
    dtype: products summed in x's dtype over blocks of rows, the block
    sums added in the accumulation dtype (a GPU GEMM has no f32 x f32 ->
    f64 form).  Full precision: TF32 would round counts above 2048."""
    E = x.shape[0]
    blk = 8192
    while E % blk:
        blk //= 2
    part = jnp.einsum(
        "bke,ke...->bk...",
        counts_b.reshape(counts_b.shape[0], E // blk, blk),
        x.reshape(E // blk, blk, *x.shape[1:]),
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.sum(part.astype(acc_dtype()), axis=1)


@jax.jit
def _rcg_init_implicit_batch(logL, counts_b, alpha, bound_const0, asum0, csum0):
    """Init for B replicates with ONE pass over logL.

    gamma_0 is counts-independent, so the per-replicate N_0 and data
    terms are contractions of exp(gamma_0) against the (B, E) counts.
    The contractions ask for full f32 precision: a TF32 product would
    round EC counts above 2048.  bound_const depends on each replicate's
    total count: shift the host-exact scalar for the ORIGINAL counts
    (bound_const0, at csum0 = sum counts, asum0 = sum unpadded alpha) by
    the lgamma ratio — a constant offset per replicate, exact in the
    telescoped deltas.
    """
    acc = acc_dtype()
    B = counts_b.shape[0]
    G = logL.shape[1]
    init_logits = jnp.where(logL > jnp.asarray(PAD_THRESHOLD, logL.dtype), 0.0, logL)
    gamma0 = _rownorm(init_logits)
    phi0 = jnp.exp(gamma0)
    n0 = alpha[None, :].astype(acc) + _contract_counts(counts_b, phi0)
    rowdata = jnp.sum(phi0 * (logL - gamma0), axis=1)  # (E,)
    data0 = _contract_counts(counts_b, rowdata)
    csum_b = jnp.sum(counts_b.astype(acc), axis=1)  # (B,)
    a0 = jnp.asarray(asum0, acc)
    bc_b = (
        jnp.asarray(bound_const0, acc)
        + gammaln(a0 + jnp.asarray(csum0, acc))
        - gammaln(a0 + csum_b)
    )
    bound0 = bc_b + jnp.sum(gammaln(n0), axis=1) + data0
    return RCGImplicitState(
        c=jnp.zeros((B,), acc),
        v=jnp.zeros((B, G), acc),
        e=jnp.zeros((B,), acc),
        f=jnp.zeros((B, G), acc),
        n_counts=n0,
        oldnorm=jnp.ones((B,), acc),
        bound=bound0,
        delta=jnp.full((B,), jnp.inf, acc),
        it=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), bool),
        just_reset=jnp.zeros((B,), bool),
    )


@partial(jax.jit, static_argnames=("length", "tol", "impl", "mesh"))
def _rcg_chunk_batch(
    state, logL, counts_b, alpha, max_it=None, *, length: int, tol: float,
    impl: str, mesh=None,
):
    """length batched iterations as one on-device lax.scan; replicates
    that converged freeze (per-replicate where, not cond — done is a
    (B,) vector).  `max_it` as in _rcg_chunk (single compile for all
    chunks)."""
    step = _make_step_implicit_batch(tol, impl, mesh)
    counts3d = counts_b[:, :, None].astype(logL.dtype)

    def body(st, _):
        new = step(st, logL, counts3d, alpha)
        if max_it is not None:
            new = new._replace(done=new.done | (new.it >= max_it))

        def keep(old, nw):
            m = st.done
            while m.ndim < nw.ndim:
                m = m[..., None]
            return jnp.where(m, old, nw)

        return jax.tree.map(keep, st, new), None

    state, _ = jax.lax.scan(body, state, None, length=length)
    return state


def fit_rcg_batch(
    problem: DeviceProblem,
    counts_batch,
    *,
    tol: float = 1e-6,
    max_iters: int = 5000,
    chunk: int = 16,
    impl: str | None = None,
):
    """rcg over a (B, E_pad) batch of count vectors sharing one logL.

    The batched form of the reference's serial bootstrap loop
    (src/mSWEEP.cpp:496-518, same likelihood matrix reused per
    replicate): replicates advance in lockstep chunks; each replicate
    freezes at its own convergence iteration, and the host loop stops
    when all are done.

    Returns (theta (B, G_pad), iters (B,), bound (B,)) — abundances
    directly, NOT gamma: a (B, E, G) gamma batch would defeat the O(G)
    state design at reference scale, and theta falls out of the
    optimizer state as (N - alpha) / sum(counts)
    (== rcgpar::mixture_components of the converged gamma,
    src/mSWEEP.cpp:420, by definition of N).

    impl None = auto (choose_impl): the implicit passes vmapped over the
    replicates (with an "ec" mesh, shard_map + psum of the (B, G)
    statistics); the vmapped explicit step on the CPU.
    """
    from .mixture import mixture_components

    if impl is None:
        impl = choose_impl(problem.logL, problem.mesh)[0]

    if impl in IMPLICIT:
        acc = acc_dtype()
        logL = problem.logL
        counts_b = jnp.asarray(counts_batch).astype(logL.dtype)
        mesh = problem.mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            counts_b = jax.device_put(counts_b, NamedSharding(mesh, P(None, "ec")))
        asum0 = float(jnp.sum(problem.alpha[: problem.n_groups]))
        csum0 = float(jnp.sum(problem.counts))
        state = _rcg_init_implicit_batch(
            logL, counts_b, problem.alpha, problem.bound_const, asum0, csum0
        )
        max_it = jnp.asarray(max_iters, jnp.int32)
        it = 0
        while it < max_iters:
            state = _rcg_chunk_batch(
                state, logL, counts_b, problem.alpha, max_it,
                length=chunk, tol=float(tol), impl=impl, mesh=mesh,
            )
            it += chunk
            if tol >= 0 and bool(jnp.all(state.done)):
                break
        csum_b = jnp.sum(counts_b.astype(acc), axis=1)
        theta = (state.n_counts - problem.alpha[None, :].astype(acc)) / csum_b[:, None]
        return theta, state.it, state.bound

    # Explicit fallback: vmapped explicit step (the CPU reference path).
    init = jax.vmap(lambda c: _rcg_init(problem.logL, c, problem.alpha, problem.bound_const))
    state = init(counts_batch)
    max_it = jnp.asarray(max_iters, jnp.int32)
    it = 0
    while it < max_iters:
        state = jax.vmap(
            lambda st, c: _rcg_chunk(
                st, problem.logL, c, problem.alpha, max_it,
                length=chunk, tol=float(tol)
            )[0]
        )(state, counts_batch)
        it += chunk
        if bool(jnp.all(state.done)):
            break
    theta = jax.vmap(mixture_components)(state.gamma, counts_batch)
    return theta, state.it, state.bound
