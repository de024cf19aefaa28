"""Smoke test of the abundance fit on an NVIDIA GPU, at the upstream
benchmark's scale (E = 8192 x 281 = 2,301,952 ECs x G = 512 groups).

Run from the root of a checkout on a machine with a GPU:

    python chip_smoke.py            # every one-card phase
    python chip_smoke.py --multi    # only the four-card phase

Phases (one card):
  a. device    the first JAX device is a GPU; versions; nvidia-smi.
  b. fit       the community likelihood through save_checkpoint and the
               CLI (--read-checkpoint, tol 1e-6): rcg and emgpu in the
               default dtype, each against its --precision double run as
               the plain f64 reference on the same card: theta within
               5e-6.  EM stops at the same iteration as its double run
               (on this problem both reach the CLI's cap of 5000: EM
               needs about 24,000 iterations to tol 1e-6), and its theta
               sums to 1.
     bootstrap the CLI with --iters 2 (its own fit matches the rcg run,
               replicate thetas sum to 1), and the vmapped Triton passes
               of the replicates against each replicate fitted alone.
  c. alignment a generated Themisto alignment pair through the CLI on the
               GPU and under JAX_PLATFORMS=cpu: same rows, theta within
               1e-5.
  d. kernels   each fused kernel against the plain jnp reference at
               E = 2^19 and 2,301,952, G = 512 and 600 (G_pad 640), with
               per-pass times for the kernel and for XLA's plain version
               and each pass's share of the card's memory bandwidth
               (bench.ROOFLINE_GBPS).
--multi runs the rcg and emgpu CLI fits (tol 1e-6) with --shards 4 and
--shards 1 on the same likelihood and compares theta, and nothing else.

A JAX process reserves most of the card's memory, so every phase that
touches the card runs in a process of its own, one after another; this
parent process never starts JAX.  A phase that fails ends the script with
a nonzero exit code and no result line.  The last line of standard
output is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
FULL_E = 8192 * 281
G_REF = 512
RESULT = "RESULT "
CLI_MAX_ITERS = 5000  # the CLI's --max-iters default


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# Parent: run phases as child processes.
# ---------------------------------------------------------------------------


def run_phase(name, *args, env=None, timeout=900):
    """Run `chip_smoke.py --phase name args...` and return its RESULT."""
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", name, *map(str, args)]
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = ROOT + os.pathsep + full_env.get("PYTHONPATH", "")
    full_env.update(env or {})
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=full_env, stdout=subprocess.PIPE,
                       text=True, timeout=timeout)
    lines = r.stdout.splitlines()
    for ln in lines:
        if not ln.startswith(RESULT):
            print(f"  [{name}] {ln}", flush=True)
    if r.returncode != 0:
        raise SmokeError(f"phase {name} {' '.join(map(str, args))} exited {r.returncode}")
    res = [ln for ln in lines if ln.startswith(RESULT)]
    check(res, f"phase {name} printed no result")
    out = json.loads(res[-1][len(RESULT):])
    print(f"phase {name} {' '.join(map(str, args))}: {time.perf_counter() - t0:.1f}s "
          f"{json.dumps(out)}", flush=True)
    return out


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60,
    )
    check(r.returncode == 0, "nvidia-smi failed")
    return r.stdout.strip()


def theta_of(path):
    """{group name: theta} from an _abundances.txt file."""
    out = {}
    with open(path) as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            name, val = ln.rstrip("\n").split("\t")[:2]
            out[name] = float(val)
    return out


def max_diff(a, b):
    check(list(a) == list(b), "abundance files list different groups")
    return max(abs(a[k] - b[k]) for k in a)


def fit_phase(ckpt, groups, prefix, *cli_args, env=None, reps=2):
    return run_phase(
        "cli", prefix, reps, "--read-checkpoint", ckpt, "-i", groups,
        "-o", prefix, "--verbose", *cli_args, env=env,
    )


def phase_fits(ckpt, groups):
    tol = ("--tol", "1e-6")
    rcg = fit_phase(ckpt, groups, os.path.join(WORK, "rcg"), *tol)
    em = fit_phase(ckpt, groups, os.path.join(WORK, "em"), *tol, "--algorithm", "emgpu")
    f64 = fit_phase(ckpt, groups, os.path.join(WORK, "rcg64"), *tol, "--precision", "double")
    em64 = fit_phase(ckpt, groups, os.path.join(WORK, "em64"), *tol, "--algorithm", "emgpu",
                     "--precision", "double", reps=1)
    check("impl=pallas" in rcg["impl"], f"default rcg did not take the kernel: {rcg['impl']}")
    check("impl=pallas" in em["impl"], f"emgpu did not take the kernel: {em['impl']}")
    d = max_diff(theta_of(rcg["abundances"]), theta_of(f64["abundances"]))
    print(f"rcg default vs --precision double: max |dtheta| = {d:.3e} (limit 5e-6)")
    check(d <= 5e-6, f"rcg theta differs from the double run by {d:.3e}")
    th = theta_of(em["abundances"])
    s = sum(th.values())
    stop = "converged" if em["iters"] < CLI_MAX_ITERS else "stopped at the CLI's cap"
    print(f"emgpu: {em['iters']} iterations ({stop}), sum theta = {s:.9f}")
    check(abs(s - 1.0) <= 1e-6, f"emgpu theta sums to {s}")
    check(em["iters"] == em64["iters"],
          f"emgpu stopped at {em['iters']} iterations, the double run at {em64['iters']}")
    d = max_diff(th, theta_of(em64["abundances"]))
    print(f"emgpu default vs --precision double: max |dtheta| = {d:.3e} (limit 5e-6)")
    check(d <= 5e-6, f"emgpu theta differs from the double run by {d:.3e}")
    return rcg


def phase_bootstrap(ckpt, groups, rcg_abundances):
    """Bootstrap replicates through the CLI (--iters 2), and the vmapped
    Triton passes they run against the same replicates fitted one by
    one without vmap."""
    prefix = os.path.join(WORK, "boot")
    fit_phase(ckpt, groups, prefix, "--tol", "1e-6", "--iters", "2", reps=1)
    cols = boot_columns(prefix + "_abundances.txt")
    d = max_diff(cols[0], theta_of(rcg_abundances))
    sums = [sum(c.values()) for c in cols[1:]]
    print(f"bootstrap CLI: mean_theta vs the rcg run max |dtheta| = {d:.3e}; "
          f"replicate theta sums {sums}")
    check(d <= 5e-6, f"bootstrap run's own fit differs from the rcg run by {d:.3e}")
    check(all(abs(x - 1.0) <= 1e-5 for x in sums), f"replicate sums {sums}")
    run_phase("bootstrap", ckpt)


def boot_columns(path):
    """[{group: theta}] per column of a bootstrap _abundances.txt."""
    cols = []
    with open(path) as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            name, *vals = ln.rstrip("\n").split("\t")
            cols += [{} for _ in range(len(vals) - len(cols))]
            for c, v in zip(cols, vals):
                c[name] = float(v)
    return cols


def phase_alignment():
    gen = run_phase("gen", WORK, timeout=600)
    args = ["--themisto-1", gen["s1"], "--themisto-2", gen["s2"], "-i", gen["groups"],
            "--tol", "1e-6", "--verbose"]
    gpu = run_phase("cli", os.path.join(WORK, "aln_gpu"), 1, *args,
                    "-o", os.path.join(WORK, "aln_gpu"))
    cpu = run_phase("cli", os.path.join(WORK, "aln_cpu"), 1, *args,
                    "-o", os.path.join(WORK, "aln_cpu"), env={"JAX_PLATFORMS": "cpu"})
    check("impl=pallas" in gpu["impl"], f"GPU alignment run: {gpu['impl']}")
    a, b = theta_of(gpu["abundances"]), theta_of(cpu["abundances"])
    d = max_diff(a, b)
    print(f"alignment run GPU vs CPU: {len(a)} groups, max |dtheta| = {d:.3e} (limit 1e-5)")
    check(d <= 1e-5, f"GPU and CPU abundances differ by {d:.3e}")


def phase_multi(ckpt, groups):
    for alg in ("rcgcpu", "emgpu"):
        runs = {}
        for shards in (4, 1):
            prefix = os.path.join(WORK, f"{alg}_s{shards}")
            runs[shards] = fit_phase(ckpt, groups, prefix, "--algorithm", alg,
                                     "--shards", shards, "--tol", "1e-6", reps=1)
            check(f"ec_shards={shards}" in runs[shards]["impl"], runs[shards]["impl"])
        d = max_diff(theta_of(runs[4]["abundances"]), theta_of(runs[1]["abundances"]))
        print(f"{alg}: --shards 4 vs --shards 1: iterations {runs[4]['iters']} vs "
              f"{runs[1]['iters']}, max |dtheta| = {d:.3e} (limit 5e-6)")
        check(d <= 5e-6, f"{alg} theta differs across shard counts by {d:.3e}")


def main_parent(multi: bool) -> int:
    dev = run_phase("device", timeout=300)
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        built = run_phase("build", WORK, FULL_E, G_REF, timeout=900)
        if multi:
            check(dev["count"] >= 4, f"--multi needs 4 devices, found {dev['count']}")
            phase_multi(built["checkpoint"], built["groups"])
        else:
            rcg = phase_fits(built["checkpoint"], built["groups"])
            phase_bootstrap(built["checkpoint"], built["groups"], rcg["abundances"])
            phase_alignment()
            run_phase("kernels", timeout=900)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}}))
    return 0


# ---------------------------------------------------------------------------
# Children: one phase each.
# ---------------------------------------------------------------------------


def emit(obj):
    print(RESULT + json.dumps(obj), flush=True)


def child_device():
    import jax
    import jaxlib

    d = jax.devices()[0]
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}; devices: "
          f"{[x.device_kind for x in jax.devices()]}")
    check(d.platform == "gpu", f"first JAX device is {d.platform}, not a GPU")
    emit({"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())})


def child_build(work, E, G):
    """The synthetic community (msweep_tpu/synth.py: sibling lineages at
    similarity 0.99, 6% of lineages present) through build_likelihood,
    saved with save_checkpoint."""
    from msweep_tpu.io.checkpoint import save_checkpoint
    from msweep_tpu.synth import make_community_likelihood

    E, G = int(E), int(G)
    t0 = time.perf_counter()
    lik = make_community_likelihood(
        E, G, seed=1, similarity=0.99, cluster_size=8, present_frac=0.06
    )
    build_s = time.perf_counter() - t0
    names = [f"lineage_{g}" for g in range(G)]
    ckpt = os.path.join(work, "community.npz")
    groups = os.path.join(work, "community_groups.txt")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, lik, names)
    with open(groups, "w") as f:
        f.write("\n".join(names) + "\n")
    emit({"checkpoint": ckpt, "groups": groups, "E": E, "G": G,
          "nnz": int(len(lik.trip_e)), "build_s": build_s,
          "save_s": time.perf_counter() - t0})


def child_cli(prefix, reps, *argv):
    """msweep_tpu.cli.main(argv) in this process, `reps` times (the first
    is cold, later ones reuse the compiled executables)."""
    import jax

    from msweep_tpu.cli import main

    fit_s, iters, impl = [], None, None
    for _ in range(int(reps)):
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            rc = main(list(argv))
        text = buf.getvalue()
        sys.stderr.write(text)
        check(rc == 0, f"CLI exited {rc}")
        m = re.search(r"optimizer finished after (\d+) iterations \(([\d.]+)s", text)
        check(m, "CLI printed no optimizer summary")
        iters = int(m.group(1))
        fit_s.append(float(m.group(2)))
        impl = re.search(r"optimizer: (impl=.*)", text).group(1)
    stats = jax.local_devices()[0].memory_stats() or {}
    emit({"iters": iters, "fit_s": fit_s, "impl": impl,
          "peak_bytes": stats.get("peak_bytes_in_use"),
          "backend": jax.default_backend(),
          "abundances": prefix + "_abundances.txt"})


def child_bootstrap(ckpt):
    """The CLI's bootstrap replicates (checkpoint, pack, resampler with the
    CLI's default seed) through fit_rcg_batch, which vmaps the Triton
    passes over the replicates, against each replicate fitted alone with
    the unbatched passes, over a fixed budget of iterations."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_enable_x64", True)  # as the CLI runs
    from msweep_tpu.cli import build_parser
    from msweep_tpu.core.sample import BootstrapResampler
    from msweep_tpu.inference import pack_problem
    from msweep_tpu.inference.rcg import _run_rcg_arrays, _state_theta, fit_rcg_batch
    from msweep_tpu.io.checkpoint import load_checkpoint

    B, iters = 2, 40
    lik, _ = load_checkpoint(ckpt)
    prob = pack_problem(lik, dtype=jnp.float32)
    seed = build_parser().parse_args(["-i", "x"]).seed
    batch = np.zeros((B, prob.counts.shape[0]))
    batch[:, : lik.n_ecs] = BootstrapResampler(lik.ec_counts, seed=seed).resample_batch(B)
    batch = jnp.asarray(batch, jnp.float32)
    t0 = time.perf_counter()
    tb, ib, _ = fit_rcg_batch(prob, batch, tol=-1.0, max_iters=iters)
    tb = np.asarray(tb)
    batch_s = time.perf_counter() - t0
    diffs = []
    t0 = time.perf_counter()
    for b in range(B):
        st, _ = _run_rcg_arrays(prob.logL, batch[b], prob.alpha, prob.bound_const,
                                tol=-1.0, max_iters=iters, verbose=False,
                                impl="pallas", refine=False)
        diffs.append(float(np.max(np.abs(tb[b] - np.asarray(_state_theta(st, batch[b], prob.alpha))))))
    serial_s = time.perf_counter() - t0
    print(f"bootstrap B={B}, {iters} iterations: vmapped {batch_s:.2f}s, serial "
          f"{serial_s:.2f}s (compile included); max |dtheta| per replicate {diffs}")
    check(max(diffs) <= 1e-6, f"vmapped replicates differ from serial fits: {diffs}")
    emit({"B": B, "iters": iters, "max_dtheta": max(diffs)})


def child_gen(work):
    """A Themisto pseudoalignment pair, 200,000 reads x 512 references in
    64 groups: each read comes from a group drawn from a skewed mixture,
    hits most of that group's references, and now and then a few others;
    the second strand drops some hits."""
    import numpy as np

    n_reads, n_refs, n_groups = 200_000, 512, 64
    rng = np.random.default_rng(5)
    group_of = np.arange(n_refs) % n_groups
    members = [np.flatnonzero(group_of == g) for g in range(n_groups)]
    theta = rng.dirichlet(np.full(n_groups, 0.3))
    src = rng.choice(n_groups, size=n_reads, p=theta)
    paths = {k: os.path.join(work, f"aln_{k}.txt") for k in ("s1", "s2")}
    with open(paths["s1"], "w") as f1, open(paths["s2"], "w") as f2:
        for r in range(n_reads):
            own = members[src[r]]
            hits = own[rng.random(len(own)) < 0.8]
            if rng.random() < 0.3:
                hits = np.union1d(hits, rng.integers(0, n_refs, size=2))
            keep = hits[rng.random(len(hits)) < 0.9]
            f1.write(" ".join(map(str, [r, *hits])) + "\n")
            f2.write(" ".join(map(str, [r, *keep])) + "\n")
    groups = os.path.join(work, "aln_groups.txt")
    with open(groups, "w") as f:
        f.write("\n".join(f"group_{g}" for g in group_of) + "\n")
    emit({**paths, "groups": groups, "reads": n_reads, "refs": n_refs})


def child_kernels():
    """Each fused kernel against the plain reference (ops/rcg_xla in f64
    for rcg, an f64 jnp EM pass), and per-pass times for the kernel and
    for XLA's plain f32 versions, at E = 2^19 and FULL_E."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_enable_x64", True)
    from bench import ROOFLINE_GBPS
    from msweep_tpu.ops import em_pallas, rcg_pallas, rcg_xla
    from msweep_tpu.utils import NEG

    em_xla = jax.jit(_em_xla)
    peak = ROOFLINE_GBPS[jax.devices()[0].device_kind] * 1e9  # bytes/s

    def timed(fn, *args, reps=10):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps, out

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))

    rows = []
    for E in (1 << 19, FULL_E):
        for G in (512, 600):
            Gp = -(-G // 128) * 128
            key = jax.random.PRNGKey(E + G)
            k1, k2, k3, k4 = jax.random.split(key, 4)
            real = jax.nn.log_softmax(
                jax.random.normal(k1, (E, G), jnp.float32) * 4.0, axis=1)
            logL = jnp.full((E, Gp), NEG, jnp.float32).at[:, :G].set(real)
            del real
            counts = jax.random.randint(k2, (E, 1), 1, 100).astype(jnp.float32)
            gmask = jnp.arange(Gp) < G
            psi = jnp.where(gmask, jax.random.normal(k3, (1, Gp)), 0.0)
            v_old = jnp.where(gmask, 0.5 * jax.random.normal(k4, (1, Gp)), 0.0)
            v_new = 0.9 * v_old + 0.1 * psi
            c_old, c_new = 0.6, 0.8
            f32 = lambda x: jnp.asarray(x, jnp.float32)
            f64 = lambda x: jnp.asarray(x, jnp.float64)
            pass_bytes = E * Gp * 4 + E * 4
            row = {"E": E, "G": G, "G_pad": Gp}

            # rcg norm pass
            ref = rcg_xla.rcg_norm(logL, counts, f64(psi), f64(c_old), f64(v_old))
            t_k, out = timed(rcg_pallas.rcg_norm, logL, counts, f32(psi), f32(c_old), f32(v_old))
            row["norm_rel_err"] = rel(out, ref)
            t_scan, _ = timed(rcg_xla.rcg_norm, logL, counts, f32(psi), f32(c_old), f32(v_old))
            t_whole, _ = timed(partial_whole(rcg_xla.rcg_norm, E), logL, counts,
                               f32(psi), f32(c_old), f32(v_old))
            row["norm_ms"] = {"kernel": t_k * 1e3, "xla_scan": t_scan * 1e3,
                              "xla_whole": t_whole * 1e3}
            row["norm_roofline_share"] = pass_bytes / t_k / peak

            # rcg update pass
            (cs_r, el_r) = rcg_xla.rcg_update(logL, counts, f64(c_old), f64(v_old),
                                              f64(c_new), f64(v_new))
            data_r, _ = rcg_xla.rcg_bound_stats(logL, counts, f64(c_old), f64(v_old))
            args32 = (logL, counts, f32(c_old), f32(v_old), f32(c_new), f32(v_new))
            t_k, (cs_k, el_k) = timed(rcg_pallas.rcg_update, *args32)
            row["colsum_rel_err"] = rel(cs_k[:G], cs_r[:G])
            row["elbo_delta_err_of_bound"] = float(abs(el_k - el_r) / abs(data_r))
            t_scan, _ = timed(rcg_xla.rcg_update, *args32)
            t_whole, _ = timed(partial_whole(rcg_xla.rcg_update, E), *args32)
            row["update_ms"] = {"kernel": t_k * 1e3, "xla_scan": t_scan * 1e3,
                                "xla_whole": t_whole * 1e3}
            row["update_roofline_share"] = pass_bytes / t_k / peak

            # EM pass: the objective change of one EM step from a uniform
            # theta_prev to theta = its M-step (the pass the fit makes).
            logt = lambda th: jnp.where(gmask, jnp.log(jnp.where(gmask, th, 1.0)), NEG)
            theta_prev = jnp.where(gmask, 1.0 / G, 0.0)
            cnt1 = counts[:, 0]
            lse_prev = row_lse(logL, logt(theta_prev))
            colsum0 = em_reference(logL, cnt1, logt(theta_prev), lse_prev)[1]
            theta = colsum0 / jnp.sum(colsum0)
            q = jnp.where(gmask, 1.0 - theta_prev / jnp.where(gmask, theta, 1.0), 0.0)
            em_args = (logL, cnt1, lse_prev.astype(jnp.float32), f32(logt(theta)), f32(q))
            t_k, (lse_k, ecs_k, dd_k) = timed(em_pallas.em_step, *em_args)
            lse_r, ecs_r, dd_r, dd_abs = em_reference(logL, cnt1, logt(theta), lse_prev)
            del lse_prev
            row["em_lse_max_abs_err"] = float(jnp.max(jnp.abs(lse_k - lse_r)))
            row["em_colsum_rel_err"] = rel(ecs_k[:G], ecs_r[:G])
            row["em_ddot_rel_err"] = float(abs(dd_k - dd_r) / abs(dd_r))
            # The same error against sum_e c_e |lse_e - lse_prev_e|: the
            # rows' changes partly cancel in ddot.
            row["em_ddot_err_of_abs"] = float(abs(dd_k - dd_r) / dd_abs)
            t_x, _ = timed(em_xla, *em_args)
            row["em_ms"] = {"kernel": t_k * 1e3, "xla_whole": t_x * 1e3}
            row["em_roofline_share"] = (pass_bytes + 2 * E * 4) / t_k / peak
            print(json.dumps(row), flush=True)
            check(row["norm_rel_err"] <= 1e-4, f"norm pass off: {row}")
            check(row["colsum_rel_err"] <= 1e-4, f"colsum off: {row}")
            check(row["elbo_delta_err_of_bound"] <= 1e-6, f"ELBO delta off: {row}")
            check(row["em_colsum_rel_err"] <= 1e-4, f"EM colsum off: {row}")
            check(row["em_lse_max_abs_err"] <= 1e-4, f"EM lse off: {row}")
            check(row["em_ddot_rel_err"] <= 1e-4, f"EM ddot off: {row}")
            rows.append(row)
            del logL, counts
    emit({"rows": len(rows)})


def partial_whole(fn, E):
    """The plain jnp pass over the whole matrix at once (one scan step)."""
    import jax

    return jax.jit(lambda *a: fn(*a, block_rows=E))


def row_lse(logL, logtheta):
    """Row logsumexp of logL + logtheta in f64."""
    import jax
    import jax.numpy as jnp

    t = logL.astype(jnp.float64) + logtheta.astype(jnp.float64)[None, :]
    return jax.scipy.special.logsumexp(t, axis=1)


def em_reference(logL, counts, logtheta, lse_prev):
    """One EM pass in f64, plain jnp: lse at theta, the counts-weighted
    responsibilities' column sums, sum_e c_e (lse_e - lse_prev_e) against
    the f64 lse_prev, and sum_e c_e |lse_e - lse_prev_e|."""
    import jax
    import jax.numpy as jnp

    t = logL.astype(jnp.float64) + logtheta.astype(jnp.float64)[None, :]
    lse = jax.scipy.special.logsumexp(t, axis=1)
    colsum = jnp.sum(counts[:, None] * jnp.exp(t - lse[:, None]), axis=0)
    d = counts * (lse - lse_prev)
    return lse, colsum, jnp.sum(d), jnp.sum(jnp.abs(d))


def _em_xla(logL, counts, lse_prev, logtheta, q):
    """em._make_step's XLA branch as one pass (f32 matrix, f64 sums)."""
    import jax
    import jax.numpy as jnp

    from msweep_tpu.inference.em import _acc_dot, _colsum_acc

    t = logL + logtheta[None, :]
    lse = jax.scipy.special.logsumexp(t, axis=1)
    p = jnp.exp(t - lse[:, None])
    pq = jnp.sum(p * q[None, :], axis=1)
    return (lse, _colsum_acc(counts[:, None] * p),
            _acc_dot(counts, jnp.log1p(jnp.exp(lse - lse_prev) * pq)))


CHILDREN = {"device": child_device, "build": child_build, "cli": child_cli,
            "gen": child_gen, "kernels": child_kernels, "bootstrap": child_bootstrap}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--phase"]:
        CHILDREN[argv[1]](*argv[2:])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase (--shards 4 vs --shards 1)")
    args = ap.parse_args(argv)
    try:
        return main_parent(args.multi)
    except (SmokeError, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
