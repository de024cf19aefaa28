"""Fused Pallas (Triton route) pass for one EM iteration (the "emgpu" algorithm).

One EM step (inference/em.py, replacing rcgpar::em_torch — call site
src/mSWEEP.cpp:202) needs exactly one pass over the (E, G) likelihood
matrix: row logsumexp at the current theta, responsibility-weighted
column sums for the M-step, and the objective change against the
previous theta.  This kernel fuses all three into a single read of logL
(plus the (E,) lse vectors, ~2/G of the matrix): a 4 B/cell floor in f32.

The objective change of row e is lse_e - lse_prev_e = log1p(sum_g
exp(t_eg - lse_prev_e) q_g), with t = logL + log theta and q = 1 -
theta_prev / theta (inference/em.py).  Its f32 rounding error is
relative to the change itself, not to |lse|, so the summed change stays
meaningful at tolerances far below f32 resolution of the objective.

Same program grid, partial sums and padding contract as
ops/rcg_pallas.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..inference.pack import acc_dtype
from .rcg_pallas import _exp, _f32, _row_tile, _row_vec, call


def _em_kernel(logL_ref, counts_ref, lse_prev_ref, logtheta_ref, q_ref,
               lse_ref, colsum_ref, ddot_ref, *, be, gb, n_prog, n_iter):
    pid = pl.program_id(0)
    logtheta = _row_vec(logtheta_ref, gb)
    q = _row_vec(q_ref, gb)

    def body(i, carry):
        col_acc, ddot_acc = carry
        r0 = (pid + i * n_prog) * be
        logL, c, rmask = _row_tile(logL_ref, counts_ref, r0, be=be, gb=gb)
        t = logL + logtheta
        m = jnp.max(t, axis=1)
        e = _exp(t - m[:, None])  # the kernel's single exp sweep
        s = jnp.sum(e, axis=1)
        lse = m + jnp.log(s)
        w = (c / s)[:, None] * e  # == c * exp(t - lse), softmax numerator reused
        plgpu.store(lse_ref.at[pl.ds(r0, be)], lse, mask=rmask)
        lse_prev = plgpu.load(lse_prev_ref.at[pl.ds(r0, be)], mask=rmask, other=0.0)
        # sum_g exp(t - lse_prev) q = exp(lse - lse_prev) * sum_g e q / s
        d = jnp.log1p(_exp(lse - lse_prev) * (jnp.sum(e * q, axis=1) / s))
        return col_acc + jnp.sum(w, axis=0), ddot_acc + c * d

    init = (jnp.zeros((gb,), jnp.float32), jnp.zeros((be,), jnp.float32))
    col_acc, ddot_acc = jax.lax.fori_loop(0, n_iter, body, init)
    colsum_ref[...] = col_acc
    ddot_ref[...] = jnp.sum(ddot_acc)


@partial(jax.jit, static_argnames=("interpret",))
def em_step(logL, counts, lse_prev, logtheta, q, *, interpret: bool = False):
    """counts, lse_prev (E,); logtheta, q (G,), where lse_prev is the row
    logsumexp at theta_prev and q = 1 - theta_prev / theta (0 where theta
    is 0).  Returns (lse (E,) f32, colsum (G,), ddot scalar), the last two
    in the accumulation dtype; ddot = sum_e counts_e (lse_e - lse_prev_e)."""
    E, G = logL.shape
    lse, colsum, ddot = call(
        _em_kernel, "em_step", E, G, ("ec", "row", "scalar"),
        (logL, _f32(counts, (E,)), _f32(lse_prev, (E,)), _f32(logtheta, (G,)),
         _f32(q, (G,))),
        interpret,
    )
    acc = acc_dtype()
    return lse, jnp.sum(colsum.astype(acc), axis=0)[:G], jnp.sum(ddot.astype(acc))
