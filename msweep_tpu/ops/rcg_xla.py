"""Plain jnp implicit-rcg passes, in any dtype.

Same math as ops/rcg_pallas.rcg_norm / rcg_update (see that module's
derivation), expressed as plain jnp so XLA can run it in float64.  Three
roles: the PRECISION-ESCALATION tail of the rcg fit (inference/rcg.py:
the f32 kernel path converges to its numerical floor, after which these
passes continue the SAME implicit O(G) iteration with f64 arithmetic
until the true tol), the "xla64" step for f64 matrices, and the plain
reference the fused kernels are checked against.

Memory: a whole-matrix jnp formulation lets XLA materialize several
(E, G) f64 temporaries.  The passes therefore lax.scan over fixed row
blocks: logL stays in its compact on-device dtype (f32, a free reshape
view), each block upcasts at most `block_rows` rows at a time, and only
(block, G) f64 temporaries ever exist.  The implicit design's O(G)
state and one read of logL per pass survive the precision escalation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import PAD_THRESHOLD

_BLOCK_ROWS = 8192  # f64 temporaries per block: 8192 x 512 x 8 B x ~6 = 200 MB


def _pick_block(E: int, block_rows: int = _BLOCK_ROWS) -> int:
    b = block_rows
    while E % b != 0:
        b //= 2
    return max(b, 1)


def _masked_softmax(logL, L, chat, vhat):
    """rcg_pallas._masked_softmax in L.dtype (the pad mask keys
    off the ORIGINAL logL values, padded cells stay at their NEG)."""
    ghat = jnp.where(logL <= jnp.asarray(PAD_THRESHOLD, logL.dtype), L, chat * L + vhat)
    m = jnp.max(ghat, axis=1, keepdims=True)
    num = jnp.exp(ghat - m)
    denom = jnp.sum(num, axis=1, keepdims=True)
    gamma = (ghat - m) - jnp.log(denom)
    return gamma, num, denom


@partial(jax.jit, static_argnames=("block_rows",))
def rcg_norm(logL, counts2d, psi, c, v, block_rows: int = _BLOCK_ROWS):
    """Pass 1 at gamma = (c, v): returns the newnorm scalar in
    psi.dtype (f64 on the escalation path)."""
    dt = psi.dtype
    E, G = logL.shape
    b = _pick_block(E, block_rows)
    Lb = logL.reshape(E // b, b, G)
    cb = counts2d.reshape(E // b, b, 1)

    def body(acc, xs):
        Lraw, cnt = xs
        L = Lraw.astype(dt)
        t = L + psi
        m1 = jnp.max(t, axis=1, keepdims=True)
        lse1 = m1 + jnp.log(jnp.sum(jnp.exp(t - m1), axis=1, keepdims=True))
        gamma, num, denom = _masked_softmax(Lraw, L, c, v)
        w = cnt.astype(dt) * (num / denom)
        s = (t - lse1) - gamma
        return acc + jnp.sum(w * s * s), None

    newnorm, _ = jax.lax.scan(body, jnp.zeros((), dt), (Lb, cb))
    return newnorm


@partial(jax.jit, static_argnames=("block_rows",))
def rcg_bound_stats(logL, counts2d, c, v, block_rows: int = _BLOCK_ROWS):
    """(data_term, colsum) of gamma = (c, v), one blocked f64 pass.

    data_term = sum_e c_e sum_g phi (L - gamma) and colsum = the N
    update — together with bound_const + lgamma(N) this is the EXACT
    f64 ELBO at (c, v).  The blind-f32 escalation tail evaluates this
    every K iterations as its honest convergence supervisor."""
    dt = c.dtype
    E, G = logL.shape
    b = _pick_block(E, block_rows)
    Lb = logL.reshape(E // b, b, G)
    cb = counts2d.reshape(E // b, b, 1)

    def body(acc, xs):
        Lraw, cnt = xs
        data, colsum = acc
        L = Lraw.astype(dt)
        gamma, num, denom = _masked_softmax(Lraw, L, c, v)
        w = cnt.astype(dt) * (num / denom)
        data = data + jnp.sum(jnp.sum(w * (L - gamma), axis=1))
        colsum = colsum + jnp.sum(w, axis=0)
        return (data, colsum), None

    (data, colsum), _ = jax.lax.scan(
        body, (jnp.zeros((), dt), jnp.zeros((G,), dt)), (Lb, cb)
    )
    return data, colsum


@partial(jax.jit, static_argnames=("block_rows",))
def rcg_update(logL, counts2d, c_old, v_old, c_new, v_new, block_rows: int = _BLOCK_ROWS):
    """Pass 2: (colsum (G,), elbo-delta scalar) at gamma' = (c_new,
    v_new), differencing the old data term recomputed at (c_old, v_old)
    per row in the same block (dual softmax — the rowelbo buffer the
    kernels also avoid; see rcg_pallas._update_kernel)."""
    dt = v_new.dtype
    E, G = logL.shape
    b = _pick_block(E, block_rows)
    Lb = logL.reshape(E // b, b, G)
    cb = counts2d.reshape(E // b, b, 1)

    def body(acc, xs):
        Lraw, cnt = xs
        colsum, elbo = acc
        L = Lraw.astype(dt)
        w_scale = cnt.astype(dt)
        g_old, num_o, den_o = _masked_softmax(Lraw, L, c_old, v_old)
        w_old = w_scale * (num_o / den_o)
        row_old = jnp.sum(w_old * (L - g_old), axis=1, keepdims=True)
        g_new, num, denom = _masked_softmax(Lraw, L, c_new, v_new)
        w_new = w_scale * (num / denom)
        colsum = colsum + jnp.sum(w_new, axis=0)
        row_new = jnp.sum(w_new * (L - g_new), axis=1, keepdims=True)
        elbo = elbo + jnp.sum(row_new - row_old)
        return (colsum, elbo), None

    (colsum, elbo), _ = jax.lax.scan(
        body, (jnp.zeros((G,), dt), jnp.zeros((), dt)), (Lb, cb)
    )
    return colsum, elbo


@jax.jit
def materialize_gamma(logL, c, v):
    """gamma = rownorm(masked affine map) — one XLA pass, used once after
    convergence when the caller needs the full (E, G) log-probabilities
    (probs output, binning, RATE).  Under GSPMD with an EC-sharded logL
    this is shard-local (rows are complete per shard)."""
    c = jnp.asarray(c, logL.dtype)
    v = jnp.asarray(v, logL.dtype)
    ghat = jnp.where(logL <= PAD_THRESHOLD, logL, c * logL + v[None, :])
    m = jnp.max(ghat, axis=1, keepdims=True)
    lse = m + jnp.log(jnp.sum(jnp.exp(ghat - m), axis=1, keepdims=True))
    return ghat - lse
