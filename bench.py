"""Benchmark harness (SURVEY.md §10 M7): multi-algorithm, multi-scale.

stdout: ONE JSON line {"metric", "value", "unit", "vs_baseline"} — the
primary metric (rcg cell-updates/s at the standard shape).  Everything
else goes to stderr and to bench_details.json (written anew by each run,
stamped with the commit and the device):

  rcg_throughput        E=2^19 x G=512 f32, fixed 30 iters (primary)
  em_throughput         same shape, fixed 30 iters (EM reads logL once
                        per iteration, so it/s is ~4x rcg's)
  rcg_convergence       tol 1e-6 run on a realistic synthetic problem:
                        iterations + seconds (reference: 220 it / 43 s
                        on an A100, docs/gpubenchmarks.md:18)
  em_convergence        tol 1e-6, capped; iterations + seconds
  rcg_reference_scale   (full suite) E=2.3M x G=512 (the efaec-1 scale);
                        OOM is caught and recorded as "spill"
  weak_scaling          (MSWEEP_BENCH_SUITE=full) 1/2/4/8-device CPU
                        mesh, E per device fixed: efficiency = it/s(n)
                        relative to it/s(1)
  phase_e2e             (MSWEEP_BENCH_SUITE=full) phase-timed pipeline
                        on a generated plaintext alignment: parse /
                        collapse / likelihood / fit / write

vs_baseline for the primary metric: the reference's own A100 rcggpu row
(docs/gpubenchmarks.md:18) ran 220 iterations over the efaec-1 problem
in 43 s with a ~28 GB f64 working set; with rcgpar-torch keeping ~3
live (G x E) f64 arrays that is ~1.16e9 cells, i.e. ~5.9e9
cell-updates/s.  vs_baseline = ours / 5.9e9.

Timing methodology: every throughput metric is min-of-3 repeats, each
closed by a host fetch of a scalar that data-depends on ALL timed
iterations (the final ELBO) — a barrier that cannot complete before
the work does.  The primary metric additionally passes a
memory-roofline guard (implied bandwidth must not exceed the device's
published peak, ROOFLINE_GBPS) and a cross-check against the EM rate
(rcg reads the matrix twice per iteration, EM once, so rcg can never be
meaningfully faster); failures re-measure with fresh data and, if
persistent, mark the output "sanity": "INVALID".

Env knobs: MSWEEP_BENCH_E/G/ITERS (primary shape), MSWEEP_BENCH_SUITE
(quick|default|full), MSWEEP_BENCH_BIG_E (reference-scale E override).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

A100_BASELINE_CELLS_PER_SEC = 5.9e9  # derived above from docs/gpubenchmarks.md:18

# Device-memory roofline per device_kind (GB/s, NVIDIA data sheets).  The
# implicit-gamma rcg reads logL exactly twice per iteration (8 B/cell of
# traffic), so cell_updates_per_s * 8 is a LOWER bound on achieved
# bandwidth — any reading above the roofline is an instrumentation
# failure, not a result.
ROOFLINE_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # H100 SXM5
}

DETAILS = {}


def log(msg):
    print(f"bench: {msg}", file=sys.stderr)


def _git_commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def _stamp(row: dict) -> dict:
    """Stamp a DETAILS row with its producing commit."""
    row["commit"] = _git_commit()
    return row


def _roofline_gbps() -> float | None:
    """The device's published memory bandwidth; None on the CPU (no
    roofline applies), an error for an accelerator not in the table."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    kind = jax.devices()[0].device_kind
    if kind not in ROOFLINE_GBPS:
        raise RuntimeError(f"no roofline entry for device kind {kind!r}")
    return ROOFLINE_GBPS[kind]


def _timed_best(run, n_rep: int = 3):
    """min-of-N timing with a data-dependent completion barrier.

    `run` must return a jax scalar that depends on ALL the timed work
    (e.g. the final ELBO); fetching it to host cannot complete before
    the compute does.  Returns (best_seconds, [seconds...]).
    """
    times = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        scalar = run()
        val = float(scalar)  # host fetch = true barrier
        times.append(time.perf_counter() - t0)
        assert np.isfinite(val), "non-finite result in bench"
    return min(times), times


def _synthetic_problem(E, G, dtype, seed=0, sharpness=4.0):
    """Realistic structure: each EC strongly prefers a few groups (keeps
    exp/logsumexp in realistic ranges), counts ~ reads-per-EC."""
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    logL = jax.nn.log_softmax(
        jax.random.normal(k1, (E, G), dtype) * sharpness, axis=1
    )
    counts = jax.random.randint(k2, (E,), 1, 100).astype(dtype)
    alpha = jnp.ones((G,), dtype)
    return logL, counts, alpha


def bench_rcg_throughput(E, G, iters):
    import jax
    import jax.numpy as jnp
    from msweep_tpu.inference.mixture import bound_const
    from msweep_tpu.inference.rcg import _fit_rcg_arrays

    roofline = _roofline_gbps()
    sanity = {"guard": "hbm_roofline", "roofline_GBps": roofline, "attempts": []}
    for attempt in range(3):
        logL, counts, alpha = _synthetic_problem(E, G, jnp.float32, seed=attempt)
        bc = bound_const(np.asarray(counts, np.float64), np.ones(G))

        # tol=-1 is bench mode: never converge, run exactly n iterations.
        # The returned bound depends on every iteration, so fetching it is
        # a true completion barrier (_timed_best).
        run = lambda n: _fit_rcg_arrays(
            logL, counts, alpha, bc, max_iters=n, tol=-1.0, verbose=False, chunk=n
        )[2]
        t0 = time.perf_counter()
        jax.block_until_ready(run(iters))
        log(f"rcg compile+warmup {time.perf_counter()-t0:.1f}s")

        elapsed, times = _timed_best(lambda: run(iters))
        rate = E * G * iters / elapsed
        implied_gbps = rate * 8 / 1e9  # 2 f32 matrix reads/iter (implicit gamma)
        sanity["attempts"].append(
            {"seconds": times, "implied_GBps": implied_gbps}
        )
        if roofline is None or implied_gbps <= roofline * 1.02:
            sanity["ok"] = True
            break
        log(f"rcg_throughput SANITY FAIL (attempt {attempt + 1}): implied "
            f"{implied_gbps:.0f} GB/s > {roofline:.0f} GB/s roofline — "
            f"re-measuring with fresh data")
        del logL, counts
    else:
        sanity["ok"] = False
        log("rcg_throughput: all attempts exceeded the HBM roofline — "
            "recording the reading as INVALID (instrumentation failure)")

    log(f"rcg_throughput: E={E} G={G} {iters} iters in {elapsed:.3f}s = "
        f"{iters/elapsed:.2f} it/s, {rate/1e9:.2f} G cell-updates/s "
        f"(min of {len(times)}; implied {implied_gbps:.0f} GB/s, "
        f"roofline {roofline or float('nan'):.0f})")
    DETAILS["rcg_throughput"] = _stamp({
        "E": E, "G": G, "iters": iters, "seconds": elapsed,
        "seconds_all": times,
        "it_per_s": iters / elapsed, "cell_updates_per_s": rate,
        "effective_GBps": implied_gbps,
        "sanity": sanity,
    })
    return rate, sanity


def bench_em_throughput(E, G, iters):
    import jax
    import jax.numpy as jnp
    from msweep_tpu.inference.em import _fit_em_arrays

    logL, counts, alpha = _synthetic_problem(E, G, jnp.float32)
    # The objective depends on every iteration: true completion barrier.
    run = lambda n: _fit_em_arrays(
        logL, counts, alpha, max_iters=n, tol=-1.0, verbose=False, chunk=n
    )[2]
    t0 = time.perf_counter()
    jax.block_until_ready(run(iters))
    log(f"em compile+warmup {time.perf_counter()-t0:.1f}s")

    elapsed, times = _timed_best(lambda: run(iters))

    rate = E * G * iters / elapsed
    log(f"em_throughput: E={E} G={G} {iters} iters in {elapsed:.3f}s = "
        f"{iters/elapsed:.2f} it/s, {rate/1e9:.2f} G cell-updates/s "
        f"(min of {len(times)})")
    DETAILS["em_throughput"] = _stamp({
        "E": E, "G": G, "iters": iters, "seconds": elapsed,
        "seconds_all": times,
        "it_per_s": iters / elapsed, "cell_updates_per_s": rate,
    })
    return rate


def _community_problem(E, G=512, dtype=None):
    """The reference-conditioned convergence workload: a synthetic
    community with near-collinear sibling lineages and mostly-absent
    groups, pushed through the REAL likelihood builder (msweep_tpu.synth
    — on it, f64 rcg needs ~237 iterations at tol 1e-6 vs the
    reference's 205-225 on efaec-1, docs/gpubenchmarks.md:15-19; the
    i.i.d. throughput synthetic converges ~5x too fast to say anything
    about reference iteration counts)."""
    import jax.numpy as jnp
    from msweep_tpu.synth import make_community_likelihood
    from msweep_tpu.inference import pack_problem

    t0 = time.perf_counter()
    lik = make_community_likelihood(
        E, G, seed=1, similarity=0.99, cluster_size=8, present_frac=0.06
    )
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = pack_problem(lik, dtype=dtype or jnp.float32)
    pack_s = time.perf_counter() - t0
    log(f"community problem: E={E} G={G} build {build_s:.1f}s pack {pack_s:.1f}s")
    return lik, prob, build_s, pack_s


def bench_convergence(E, G, tol=1e-6):
    """Convergence on the reference-conditioned community workload:
    rcg with precision escalation (the production default), the raw f32
    floor for the record, and the EM precision-trajectory rows that
    mirror the reference's float-vs-double behavior (SURVEY.md §3.4)."""
    import jax
    from msweep_tpu.inference.rcg import fit_rcg_result
    from msweep_tpu.inference.em import fit_em_result

    E = int(os.environ.get("MSWEEP_BENCH_CONV_E", E))
    cap = 5000
    lik, prob, build_s, pack_s = _community_problem(E, G)

    t0 = time.perf_counter()
    res = fit_rcg_result(prob, tol=tol, max_iters=cap, chunk=64)
    jax.block_until_ready(res.theta)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = fit_rcg_result(prob, tol=tol, max_iters=cap, chunk=64)
    jax.block_until_ready(res.theta)
    warm_s = time.perf_counter() - t0
    raw = fit_rcg_result(prob, tol=tol, max_iters=cap, chunk=64, refine=False)
    it = int(res.n_iters)
    hit_cap = it >= cap
    log(f"rcg_convergence (community): tol={tol} "
        f"{'hit the ' + str(cap) + '-iter cap' if hit_cap else f'converged in {it} iters'} "
        f"({int(raw.n_iters)} f32 + {it - int(raw.n_iters)} f64-escalated), "
        f"{warm_s:.2f}s warm / {cold_s:.2f}s cold — reference A100: "
        f"220 it / 43 s at efaec scale")
    DETAILS["rcg_convergence"] = _stamp({
        "E": E, "G": G, "tol": tol, "iters": it,
        "iters_f32_floor": int(raw.n_iters), "hit_cap": hit_cap,
        "seconds": warm_s, "seconds_cold": cold_s,
        "build_s": build_s, "pack_s": pack_s,
        "bound": float(res.objective), "workload": "community",
    })

    # EM, f32 matrices + f64 delta accumulation (the honest criterion):
    # expected to hit the cap exactly like the reference's emgpu DOUBLE
    # run (5000-iter cap, docs/gpubenchmarks.md:20) — our f32 path does
    # not inherit float's spurious early convergence because the delta
    # is tracked in f64.
    t0 = time.perf_counter()
    rese = fit_em_result(prob, tol=tol, max_iters=cap, chunk=64)
    jax.block_until_ready(rese.theta)
    elapsed = time.perf_counter() - t0
    it = int(rese.n_iters)
    hit_cap = it >= cap
    log(f"em_convergence: tol={tol} "
        f"{'hit the ' + str(cap) + '-iter cap' if hit_cap else f'converged in {it} iters'}, "
        f"{elapsed:.2f}s (f32 matrices, f64 accumulation)")
    DETAILS["em_convergence"] = _stamp({
        "E": E, "G": G, "tol": tol, "iters": it, "hit_cap": hit_cap,
        "seconds": elapsed, "workload": "community",
    })

    # Reference --emprecision float emulation: with f32 delta
    # accumulation the criterion quantizes and fires early — the
    # reference's float-converges-in-335 behavior is a rounding
    # artifact, not faster convergence (docs/gpubenchmarks.md:22).
    with jax.enable_x64(False):
        t0 = time.perf_counter()
        resf = fit_em_result(prob, tol=tol, max_iters=cap, chunk=64)
        jax.block_until_ready(resf.theta)
        elapsed = time.perf_counter() - t0
    it = int(resf.n_iters)
    hit_cap = it >= cap
    log(f"em_convergence_f32acc: tol={tol} "
        f"{'hit the ' + str(cap) + '-iter cap' if hit_cap else f'converged in {it} iters'} "
        f"(float accumulation, reference emgpu-float emulation), {elapsed:.2f}s")
    DETAILS["em_convergence_f32acc"] = _stamp({
        "E": E, "G": G, "tol": tol, "iters": it, "hit_cap": hit_cap,
        "seconds": elapsed, "workload": "community",
    })
    return lik


def bench_em_precision(lik, tol=1e-6, cap=5000):
    """EM double-precision trajectory (full suite; VERDICT r04 item 5):
    the reference's emgpu double hits its 5000-iter cap at tol 1e-6
    while float converges in 335 (docs/gpubenchmarks.md:20-25).  Runs
    the f64-matrix EM on the community workload to the same cap."""
    import jax
    import jax.numpy as jnp
    from msweep_tpu.inference import pack_problem
    from msweep_tpu.inference.em import fit_em_result

    prob = pack_problem(lik, dtype=jnp.float64)
    t0 = time.perf_counter()
    res = fit_em_result(prob, tol=tol, max_iters=cap, chunk=64)
    jax.block_until_ready(res.theta)
    elapsed = time.perf_counter() - t0
    it = int(res.n_iters)
    hit_cap = it >= cap
    log(f"em_convergence_f64: tol={tol} "
        f"{'hit the ' + str(cap) + '-iter cap' if hit_cap else f'converged in {it} iters'} "
        f"(double matrices — reference emgpu double: 5000 hit cap), {elapsed:.2f}s")
    DETAILS["em_convergence_f64"] = _stamp({
        "E": lik.n_ecs, "G": lik.n_groups, "tol": tol, "iters": it,
        "hit_cap": hit_cap, "seconds": elapsed, "workload": "community",
    })


def bench_convergence_reference(G, tol=1e-6):
    """Full-suite: the efaec-scale convergence problem end-to-end —
    E=2.3M community ECs through the real likelihood builder, rcg with
    precision escalation to honest tol.  The comparable reference row
    is rcggpu on an A100: 43 s / 220 iterations / 27.9 GB
    (docs/gpubenchmarks.md:18)."""
    import jax
    from msweep_tpu.inference.rcg import fit_rcg_result

    E = int(os.environ.get("MSWEEP_BENCH_BIG_E", 8192 * 281))
    try:
        lik, prob, build_s, pack_s = _community_problem(E, G)
        t0 = time.perf_counter()
        res = fit_rcg_result(prob, tol=tol, max_iters=5000, chunk=64)
        jax.block_until_ready(res.theta)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = fit_rcg_result(prob, tol=tol, max_iters=5000, chunk=64)
        jax.block_until_ready(res.theta)
        warm_s = time.perf_counter() - t0
        it = int(res.n_iters)
        log(f"rcg_convergence_reference_scale: E={E} tol={tol} "
            f"converged in {it} iters, {warm_s:.1f}s warm / {cold_s:.1f}s cold "
            f"(A100 rcggpu: 220 it / 43 s / 27.9 GB)")
        DETAILS["rcg_convergence_reference_scale"] = _stamp({
            "E": E, "G": G, "tol": tol, "iters": it,
            "seconds": warm_s, "seconds_cold": cold_s,
            "build_s": build_s, "pack_s": pack_s,
            "a100_reference_s": 43.0, "a100_reference_iters": 220,
            "workload": "community",
        })
        del lik, prob
    except Exception as e:
        log(f"rcg_convergence_reference_scale FAILED ({type(e).__name__}): "
            f"{str(e)[:200]}")
        DETAILS["rcg_convergence_reference_scale"] = _stamp({
            "E": E, "G": G, "status": "failed", "error": str(e)[:300],
        })


def bench_capacity(G, iters=20):
    """Full-suite: the largest-problem row — E=5.7M x 512 (10.9 GiB
    matrix, 2.5x the reference benchmark's efaec-1) on one card.
    Data is generated host-side (device-side softmax temporaries would
    not fit) and timed with the standard min-of-N + barrier method.
    The reference's A100 run held 27.9 GB for the 2.3M-EC problem; this
    row exists because the O(G)-state design makes logL itself the only
    matrix-sized allocation."""
    import jax
    import jax.numpy as jnp
    from msweep_tpu.inference.mixture import bound_const
    from msweep_tpu.inference.rcg import _run_rcg_arrays

    E = int(os.environ.get("MSWEEP_BENCH_CAP_E", 8192 * 700))  # 5,734,400
    try:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((E, G), dtype=np.float32) * 4.0
        x -= x.max(axis=1, keepdims=True)
        ex = np.exp(x)
        x -= np.log(ex.sum(axis=1, keepdims=True))
        del ex
        logL = jax.device_put(x)
        jax.block_until_ready(logL)
        del x
        counts_h = rng.integers(1, 100, size=E).astype(np.float32)
        counts = jax.device_put(counts_h)
        alpha = jnp.ones((G,), jnp.float32)
        bc = bound_const(counts_h.astype(np.float64), np.ones(G))

        def run(n):
            st, _ = _run_rcg_arrays(
                logL, counts, alpha, bc, max_iters=n, tol=-1.0,
                verbose=False, chunk=n,
            )
            return st.bound

        t0 = time.perf_counter()
        jax.block_until_ready(run(iters))
        log(f"capacity compile+warmup {time.perf_counter()-t0:.1f}s")
        elapsed, times = _timed_best(lambda: run(iters))
        rate = E * G * iters / elapsed
        log(f"rcg_capacity: E={E} ({E*G*4/2**30:.1f} GiB) {iters} iters in "
            f"{elapsed:.3f}s = {rate/1e9:.1f} G cell-updates/s (min of "
            f"{len(times)}; 2.5x reference scale on one card)")
        DETAILS["rcg_capacity"] = _stamp({
            "E": E, "G": G, "iters": iters, "seconds": elapsed,
            "seconds_all": times, "it_per_s": iters / elapsed,
            "cell_updates_per_s": rate,
            "working_set_GiB": E * G * 4 / 2**30,
        })
        del logL, counts
    except Exception as e:
        log(f"rcg_capacity FAILED ({type(e).__name__}): {str(e)[:200]}")
        DETAILS["rcg_capacity"] = _stamp({
            "E": E, "G": G, "status": "failed", "error": str(e)[:300],
        })


def bench_reference_scale(G, iters=10):
    """efaec-1 scale (~2.3M ECs, docs/gpubenchmarks.md:13).  With the
    implicit-gamma rcg the device working set is logL alone (2.3M x 512
    f32 = 4.5 GiB) — the reference's A100 run needed 27.9 GB."""
    import jax
    import jax.numpy as jnp
    from msweep_tpu.inference.mixture import bound_const
    from msweep_tpu.inference.rcg import _fit_rcg_arrays

    E = int(os.environ.get("MSWEEP_BENCH_BIG_E", 8192 * 281))  # 2,301,952
    try:
        logL, counts, alpha = _synthetic_problem(E, G, jnp.float32)
        bc = bound_const(np.asarray(counts, np.float64), np.ones(G))
        run = lambda n: _fit_rcg_arrays(
            logL, counts, alpha, bc, max_iters=n, tol=-1.0, verbose=False, chunk=n
        )[2]
        t0 = time.perf_counter()
        jax.block_until_ready(run(iters))
        log(f"reference-scale compile+warmup {time.perf_counter()-t0:.1f}s")
        elapsed, times = _timed_best(lambda: run(iters))
        rate = E * G * iters / elapsed
        log(f"rcg_reference_scale: E={E} ({E/1e6:.2f}M ECs) G={G} "
            f"{iters} iters in {elapsed:.3f}s = {iters/elapsed:.2f} it/s, "
            f"{rate/1e9:.2f} G cell-updates/s (min of {len(times)}; "
            f"working set {E*G*4/2**30:.1f} GiB: logL only, implicit gamma)")
        DETAILS["rcg_reference_scale"] = _stamp({
            "E": E, "G": G, "iters": iters, "seconds": elapsed,
            "seconds_all": times,
            "it_per_s": iters / elapsed, "cell_updates_per_s": rate,
            "working_set_GiB": E * G * 4 / 2**30,
        })
        del logL, counts
    except Exception as e:  # XlaRuntimeError OOM and friends
        log(f"rcg_reference_scale: E={E} G={G} FAILED ({type(e).__name__}): "
            f"{str(e)[:200]}")
        DETAILS["rcg_reference_scale"] = _stamp({
            "E": E, "G": G, "status": "spill/oom", "error": str(e)[:300],
        })


_WEAK_SCALING_CHILD = r"""
import json, os, sys, time
import numpy as np
n = int(sys.argv[1])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={n}"
)
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, os.getcwd())
from msweep_tpu.inference.mixture import bound_const
from msweep_tpu.inference.rcg import _fit_rcg_arrays

E_PER, G, ITERS = 1 << 13, 256, 6
E = E_PER * n
mesh = Mesh(np.array(jax.devices()[:n]), ("ec",))
k1, k2 = jax.random.split(jax.random.PRNGKey(0))
logL = jax.device_put(
    jax.nn.log_softmax(jax.random.normal(k1, (E, G), jnp.float32) * 4.0, axis=1),
    NamedSharding(mesh, P("ec", None)),
)
counts = jax.device_put(
    jax.random.randint(k2, (E,), 1, 100).astype(jnp.float32),
    NamedSharding(mesh, P("ec")),
)
alpha = jnp.ones((G,), jnp.float32)
bc = bound_const(np.asarray(counts, np.float64), np.ones(G))
run = lambda: _fit_rcg_arrays(
    logL, counts, alpha, bc, max_iters=ITERS, tol=-1.0, verbose=False,
    chunk=ITERS, mesh=mesh,
)
jax.block_until_ready(run())
# best-of-3: the CPU-sim children share the host's few cores with
# whatever else runs there, so single timings are noisy.
dt = min(
    (lambda t0: (jax.block_until_ready(run()), time.time() - t0)[1])(time.time())
    for _ in range(3)
)
print(json.dumps({"n": n, "E": E, "it_per_s": ITERS / dt}))
"""


def bench_weak_scaling():
    """Sharded rcg on 1/2/4/8 virtual CPU devices, E per device fixed.

    Each child process forces the CPU backend and runs the step the CLI
    would pick there (the explicit step under GSPMD), so the absolute
    it/s is meaningless — the *ratio* measures collective + sharding
    overhead on the host."""
    results = []
    for n in (1, 2, 4, 8):
        r = subprocess.run(
            [sys.executable, "-c", _WEAK_SCALING_CHILD, str(n)],
            capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
            timeout=1200,
        )
        if r.returncode != 0:
            log(f"weak_scaling n={n} FAILED: {r.stderr[-300:]}")
            return
        row = json.loads(r.stdout.strip().splitlines()[-1])
        results.append(row)
        log(f"weak_scaling: n={row['n']} E={row['E']} {row['it_per_s']:.2f} it/s")
    # Virtual devices share the host's physical cores: once n exceeds
    # them, the ratio measures oversubscription, not sharding overhead.
    # Score efficiency at the largest non-oversubscribed n; larger n
    # rows remain as functional (correct-under-sharding) evidence.
    cores = os.cpu_count() or 1
    scored = [r for r in results if r["n"] <= cores] or results[:1]
    eff = scored[-1]["it_per_s"] / results[0]["it_per_s"]
    log(
        f"weak_scaling efficiency ({scored[-1]['n']} dev vs 1, E/device "
        f"fixed, host has {cores} cores): {eff:.2%}"
    )
    DETAILS["weak_scaling"] = _stamp({
        "rows": results,
        "host_cores": cores,
        "efficiency_n": scored[-1]["n"],
        "efficiency": eff,
    })


def bench_phase_e2e(n_reads=None, n_refs=512, n_groups=64):
    if n_reads is None:
        n_reads = int(os.environ.get("MSWEEP_BENCH_E2E_READS", 200_000))
    """Phase-timed pipeline on a generated plaintext alignment
    (gpubenchmarks.md methodology: the reference times the estimation
    call; here every phase is timed)."""
    import tempfile

    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="msweep_bench_")
    aln = os.path.join(tmp, "aln.txt")
    grp = os.path.join(tmp, "groups.txt")
    t0 = time.time()
    with open(grp, "w") as f:
        for i in range(n_refs):
            f.write(f"g{i % n_groups}\n")
    with open(aln, "w") as f:
        base = rng.integers(0, n_refs, size=n_reads)
        extra = rng.integers(1, 40, size=n_reads)
        for r in range(n_reads):
            hits = np.unique(rng.integers(0, n_refs, size=extra[r]))
            f.write(f"{r} {base[r]} " + " ".join(map(str, hits)) + "\n")
    gen_s = time.time() - t0

    from msweep_tpu.io.grouping import read_reference
    from msweep_tpu.io.themisto import merge_strands, parse_plaintext_pairs
    from msweep_tpu.io.compressed import read_input_bytes
    from msweep_tpu.core.alignment import collapse
    from msweep_tpu.core.likelihood import build_likelihood
    from msweep_tpu.inference.pack import pack_problem
    from msweep_tpu.inference.rcg import fit_rcg_result
    import jax
    import jax.numpy as jnp

    phases = {}
    t0 = time.time()
    reference = read_reference(grp)
    buf = read_input_bytes(aln)
    r, t, n_seen = parse_plaintext_pairs(buf)
    keys = merge_strands([(r, t)], reference.n_refs, "intersection")
    phases["parse_s"] = time.time() - t0

    t0 = time.time()
    ec = collapse(keys, reference.n_refs, n_seen)
    phases["collapse_s"] = time.time() - t0

    t0 = time.time()
    grouping = reference.groupings[0]
    lik = build_likelihood(ec, grouping.indicators, grouping.sizes)
    phases["likelihood_s"] = time.time() - t0

    t0 = time.time()
    prob = pack_problem(lik, dtype=jnp.float32)
    res = fit_rcg_result(prob, tol=1e-6, max_iters=2000)
    jax.block_until_ready(res.n_iters)
    phases["fit_s"] = time.time() - t0
    phases["fit_iters"] = int(res.n_iters)

    # Abundances come straight from the O(G) optimizer state — no gamma
    # materialization or (E, G) transfer on the plain path.
    t0 = time.time()
    theta = np.asarray(res.theta)[: prob.n_groups]
    phases["abundances_s"] = time.time() - t0
    phases["n_ecs"] = ec.n_ecs

    log(f"phase_e2e (n_reads={n_reads}, gen {gen_s:.1f}s): " +
        " ".join(f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in phases.items()))
    DETAILS["phase_e2e"] = _stamp({"n_reads": n_reads, "n_refs": n_refs,
                                   "n_groups": n_groups, **phases})
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)


def main():
    import jax

    jax.config.update("jax_enable_x64", True)  # f64 scalar accumulation
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # Persistent compilation cache (same as the CLI): compile time is
    # logged separately from every timed region, so cache hits only cut
    # the untimed warmup.
    from msweep_tpu.utils import setup_compile_cache

    setup_compile_cache()

    E = int(os.environ.get("MSWEEP_BENCH_E", 1 << 19))
    G = int(os.environ.get("MSWEEP_BENCH_G", 512))
    iters = int(os.environ.get("MSWEEP_BENCH_ITERS", 30))
    suite = os.environ.get("MSWEEP_BENCH_SUITE", "default")

    dev = jax.devices()[0]
    log(f"suite={suite} backend={jax.default_backend()} "
        f"device={getattr(dev, 'device_kind', '?')} n_devices={len(jax.devices())}")
    DETAILS["config"] = {
        "suite": suite, "backend": jax.default_backend(),
        "device_kind": getattr(dev, "device_kind", "?"),
        "n_devices": len(jax.devices()),
    }

    primary, sanity = bench_rcg_throughput(E, G, iters)

    if suite != "quick":
        em_rate = bench_em_throughput(E, G, iters)
        # Cross-check: rcg reads logL twice per iteration, EM once, so
        # rcg cell-rate must be at most ~EM's (never meaningfully above).
        # A violation means one of the two timings is broken.
        if em_rate and primary > em_rate * 1.5:
            sanity["ok"] = False
            sanity["cross_check"] = (
                f"rcg rate {primary/1e9:.1f}G > 1.5x em rate {em_rate/1e9:.1f}G"
            )
            log(f"SANITY FAIL cross-check: {sanity['cross_check']}")
        else:
            sanity["cross_check"] = "rcg<=1.5x em ok"
        lik = bench_convergence(1 << 17, G)
    if suite == "full":
        bench_reference_scale(G)
        bench_capacity(G)
        bench_convergence_reference(G)
        bench_em_precision(lik)
        bench_phase_e2e()
        bench_weak_scaling()

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_details.json")
    with open(out, "w") as f:
        json.dump(DETAILS, f, indent=1)
    log(f"details -> {out}")

    print(
        json.dumps(
            {
                "metric": "rcg_cell_updates_per_sec",
                "value": primary,
                "unit": "cells/s",
                "vs_baseline": primary / A100_BASELINE_CELLS_PER_SEC,
                "sanity": "ok" if sanity.get("ok", True) else "INVALID",
            }
        )
    )


if __name__ == "__main__":
    main()
