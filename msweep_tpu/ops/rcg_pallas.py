"""Fused Pallas (Triton route) passes for one rcg iteration, with IMPLICIT gamma.

The rcg step (inference/rcg.py, reconstructing rcgpar::rcg_optl_* — call
sites src/mSWEEP.cpp:176-205) is, in explicit form, a stream over three
(E, G) matrices (logL, gamma, direction) per iteration.  But the update
recursion makes gamma an affine function of logL: with t_k = logL + psi_k
(psi_k a (G,) row vector) the implemented step is

    gamma_k = rownorm(t_k + beta_k * d_k),      d_k = s_k + beta_k d_{k-1},
    s_k     = rownorm(t_k) - gamma_{k-1},

and row-constant shifts of d never affect gamma (they cancel in the row
normalization) nor any reduction (the norm uses s, not d).  So modulo
row constants

    gamma_k = rownorm(c_k * logL + v_k),        d_k ~ e_k * logL + f_k,

with the tiny recursion (scalar c, e; (G,) vectors v, f):

    e_k = (1 - c_{k-1}) + beta_k e_{k-1}        # from s_k's affine form
    f_k = (psi_k - v_{k-1}) + beta_k f_{k-1}
    c_k = c_{k-1} + e_k,   v_k = v_{k-1} + f_k

A momentum reset (beta = 0) gives c = 1, v = psi — the exact VB step —
and the initial gamma_0 = rownorm(where(logL > PAD, 0, logL)) is (c, v)
= (0, 0) under the same pad masking used in the kernels.

Consequences:

- NO (E, G) state is stored at all.  One iteration reads logL twice
  (norm pass, then update pass) and writes nothing big: an 8 B/cell
  device-memory floor in f32.  gamma is materialized once after
  convergence, only if the caller needs it (probs/binning;
  ops/rcg_xla.materialize_gamma).
- The working set is logL alone (2.3M ECs x 512 groups f32 = 4.7 GB).
- Accept/revert and convergence bookkeeping act on O(G) state.

Exp sweeps per iteration: four.  The norm pass takes the row logsumexp
of t and gamma's row softmax (whose numerator gives the metric weights
w = counts * exp(gamma)); the update pass takes gamma's softmax again
(the old ELBO row term, recomputed in-stream) and the new gamma's.  The
ELBO data-term change is accumulated from per-row differences WITHIN
the update pass: the old term sum_g w (logL - gamma) at (c, v) and the
new one at (c', v') come from the same masked-softmax helper, so the
nearly-cancelling row pairs keep f64-summed totals accurate at
tolerances far below f32 resolution of the whole term (rcg.py module
docstring point 2).

GPU structure: a grid of `_programs(...)` programs.  Program p walks the
row blocks p, p + P, p + 2P, ... in a fori_loop, holding one (be, gb)
tile of logL in registers per step (gb = G rounded up to a power of two,
masked loads fill the columns past G and the rows past E with NEG), and
keeps its partial sums in f32.  Each program writes one partial row;
the caller sums the P partials in f64.  No atomics, so results are the
same from run to run.

Padding contract (inference/pack.py): padded rows have counts == 0 so
they contribute 0 to every partial; padded group columns hold NEG, and
both kernels force cells with logL <= PAD_THRESHOLD to logL itself
(bypassing the affine map) so their softmax weight underflows to 0
exactly no matter what (c, v) are.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..inference.pack import acc_dtype
from ..utils import NEG, PAD_THRESHOLD

# Launch shape.  On an H100 at E = 2.3M x G = 512, tiles of 4096 to
# 16384 cells, 4 to 16 warps, 528 or 1056 programs and 1 to 4 pipeline
# stages all time within 2% of each other (PERF.md).
_MAX_G = 4096  # widest row one program holds in registers
_TILE = 4096  # f32 elements of one (be, gb) tile
_NUM_WARPS = 4
_PROGRAMS = 132 * 4  # four programs for each of an H100's 132 SMs
_LOG2E = 1.4426950408889634


def _exp(x):
    """exp through exp2, which maps onto the hardware's base-2
    exponential (with the per-row reciprocals in place of per-cell
    divisions, 5-8% off each pass on an H100; PERF.md)."""
    return jnp.exp2(x * _LOG2E)


def supports(logL) -> bool:
    return logL.dtype == jnp.float32 and logL.ndim == 2 and logL.shape[1] <= _MAX_G


def tile_shape(G: int) -> tuple[int, int]:
    """(be, gb): rows per tile and the power-of-two tile width >= G."""
    gb = pl.next_power_of_2(G)
    return max(1, _TILE // gb), gb


def _programs(E: int, be: int) -> int:
    return max(1, min(_PROGRAMS, pl.cdiv(E, be)))


def _masked_softmax(logL, chat, vhat):
    """Row softmax of the affine map ghat = chat*logL + vhat with the pad
    mask applied THROUGH logL itself (padded cells hold NEG and stay NEG).

    Returns (gamma, num, denom) with gamma = ghat - lse(ghat), num the
    (be, gb) softmax numerator and denom its (be,) row sums, so callers
    get exp(gamma) == num / denom without another exp sweep (and divide
    once per row, not per cell).  Both kernels MUST build gamma through
    this one helper: the ELBO row differencing relies on recomputing
    bit-identical values from the same (c, v).
    """
    ghat = jnp.where(logL <= PAD_THRESHOLD, logL, chat * logL + vhat)
    shifted = ghat - jnp.max(ghat, axis=1)[:, None]
    num = _exp(shifted)
    denom = jnp.sum(num, axis=1)
    gamma = shifted - jnp.log(denom)[:, None]
    return gamma, num, denom


def _data_rows(logL, counts, chat, vhat):
    """Per-row ELBO data term counts * sum_g exp(gamma) (logL - gamma) at
    gamma = (chat, vhat), with the softmax numerator and the per-row
    weight scale counts / denom.  The update pass differences this term
    at the old and the new (c, v); one expression for both keeps the
    telescoping rows bit-identical from one iteration to the next."""
    gamma, num, denom = _masked_softmax(logL, chat, vhat)
    scale = counts / denom
    return jnp.sum(num * (logL - gamma), axis=1) * scale, num, scale


def _row_tile(logL_ref, counts_ref, r0, *, be, gb):
    """Rows [r0, r0 + be) of logL as a (be, gb) tile (NEG past E and
    past G), their counts as (be,) (0 past E) and the row mask."""
    E, G = logL_ref.shape
    rows = r0 + jnp.arange(be, dtype=jnp.int32)
    rmask = rows < E
    cmask = jnp.arange(gb, dtype=jnp.int32) < G
    L = plgpu.load(
        logL_ref.at[pl.ds(r0, be), pl.ds(0, gb)],
        mask=rmask[:, None] & cmask[None, :], other=NEG,
    )
    cnt = plgpu.load(counts_ref.at[pl.ds(r0, be)], mask=rmask, other=0.0)
    return L, cnt, rmask


def _row_vec(ref, gb):
    """A (G,) operand as a (1, gb) row, 0 past G."""
    G = ref.shape[0]
    cmask = jnp.arange(gb, dtype=jnp.int32) < G
    return plgpu.load(ref.at[pl.ds(0, gb)], mask=cmask, other=0.0)[None, :]


def _norm_kernel(logL_ref, counts_ref, psi_ref, v_ref, c_ref, norm_ref, *,
                 be, gb, n_prog, n_iter):
    pid = pl.program_id(0)
    psi = _row_vec(psi_ref, gb)
    v = _row_vec(v_ref, gb)
    c = c_ref[0]

    def body(i, acc):
        r0 = (pid + i * n_prog) * be
        logL, counts, _ = _row_tile(logL_ref, counts_ref, r0, be=be, gb=gb)
        t = logL + psi
        m1 = jnp.max(t, axis=1)
        lse1 = m1 + jnp.log(jnp.sum(_exp(t - m1[:, None]), axis=1))
        gamma, num, denom = _masked_softmax(logL, c, v)
        w = num * (counts / denom)[:, None]  # == counts * exp(gamma)
        s = (t - lse1[:, None]) - gamma  # natural-gradient direction (exact row consts)
        return acc + jnp.sum(w * s * s, axis=1)

    acc = jax.lax.fori_loop(0, n_iter, body, jnp.zeros((be,), jnp.float32))
    norm_ref[...] = jnp.sum(acc)


def _update_kernel(logL_ref, counts_ref, vo_ref, vn_ref, c_ref,
                   colsum_ref, elbo_ref, *, be, gb, n_prog, n_iter):
    """Dual-softmax update pass: evaluates BOTH the old gamma (c_old,
    v_old) and the stepped gamma' (c_new, v_new) in one stream and
    differences the ELBO data term per row in-kernel (c_ref holds
    [c_old, c_new])."""
    pid = pl.program_id(0)
    v_old = _row_vec(vo_ref, gb)
    v_new = _row_vec(vn_ref, gb)
    c_old = c_ref[0]
    c_new = c_ref[1]

    def body(i, carry):
        col_acc, elbo_acc = carry
        r0 = (pid + i * n_prog) * be
        logL, counts, _ = _row_tile(logL_ref, counts_ref, r0, be=be, gb=gb)
        row_old, _, _ = _data_rows(logL, counts, c_old, v_old)
        row_new, num, scale = _data_rows(logL, counts, c_new, v_new)
        w_new = num * scale[:, None]
        return col_acc + jnp.sum(w_new, axis=0), elbo_acc + (row_new - row_old)

    init = (jnp.zeros((gb,), jnp.float32), jnp.zeros((be,), jnp.float32))
    col_acc, elbo_acc = jax.lax.fori_loop(0, n_iter, body, init)
    colsum_ref[...] = col_acc
    elbo_ref[...] = jnp.sum(elbo_acc)


def call(kernel, name, E, G, outputs, args, interpret):
    """Run `kernel` over the program grid.  `outputs` names each f32
    result: "row" a (P, gb) partial row per program, "scalar" a (P,)
    partial per program, "ec" an (E,) vector every program writes its
    own rows of."""
    be, gb = tile_shape(G)
    n_prog = _programs(E, be)
    n_iter = pl.cdiv(pl.cdiv(E, be), n_prog)
    shapes = {"row": (n_prog, gb), "scalar": (n_prog,), "ec": (E,)}
    specs = {
        "row": pl.BlockSpec((None, gb), lambda p: (p, 0)),
        "scalar": pl.BlockSpec((None,), lambda p: (p,)),
        "ec": pl.no_block_spec,
    }
    return pl.pallas_call(
        partial(kernel, be=be, gb=gb, n_prog=n_prog, n_iter=n_iter),
        grid=(n_prog,),
        out_specs=[specs[k] for k in outputs],
        out_shape=[jax.ShapeDtypeStruct(shapes[k], jnp.float32) for k in outputs],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name=name,
    )(*args)


def _f32(x, shape):
    return jnp.asarray(x, jnp.float32).reshape(shape)


@partial(jax.jit, static_argnames=("interpret",))
def rcg_norm(logL, counts2d, psi, c, v, *, interpret: bool = False):
    """Pass 1: metric norm of the natural gradient at gamma = (c, v).

    counts2d (E, 1); psi, v (1, G) or (G,); c scalar.  Returns the
    newnorm scalar (f64 when x64 is on: the per-program f32 partials are
    summed in the accumulation dtype)."""
    E, G = logL.shape
    (norm,) = call(
        _norm_kernel, "rcg_norm", E, G, ("scalar",),
        (logL, _f32(counts2d, (E,)), _f32(psi, (G,)), _f32(v, (G,)),
         _f32(c, (1,))),
        interpret,
    )
    return jnp.sum(norm.astype(acc_dtype()))


@partial(jax.jit, static_argnames=("interpret",))
def rcg_update(logL, counts2d, c_old, v_old, c_new, v_new, *,
               interpret: bool = False):
    """Pass 2: sufficient statistics of the stepped gamma' = (c_new,
    v_new), plus the ELBO data-term change vs gamma = (c_old, v_old).

    Returns (colsum (G,), elbo_delta scalar) in the accumulation dtype,
    where colsum = sum_e counts_e exp(gamma'_e) (the N update / final
    abundances).  Neither gamma is ever written — the caller carries
    only the O(G) coefficients."""
    E, G = logL.shape
    cs = jnp.stack([_f32(c_old, ()), _f32(c_new, ())])
    colsum, elbo = call(
        _update_kernel, "rcg_update", E, G, ("row", "scalar"),
        (logL, _f32(counts2d, (E,)), _f32(v_old, (G,)), _f32(v_new, (G,)), cs),
        interpret,
    )
    acc = acc_dtype()
    return jnp.sum(colsum.astype(acc), axis=0)[:G], jnp.sum(elbo.astype(acc))
