"""Command-line driver (layer L9): the `mSWEEP`-compatible CLI.

Flag surface, defaults, and output contract follow src/mSWEEP.cpp:68-160
(table in SURVEY.md section 5).  Algorithm names rcgcpu/rcggpu/emgpu are accepted
for compatibility; on this framework rcgcpu and rcggpu are the same
program (run on whatever device jax selects), emgpu is the EM path.

Extensions beyond the reference surface (all optional, all prefixed
into the "Experimental options" group):
  --backend     force a jax platform (gpu/cpu) instead of the default
  --precision   matrix dtype for ANY algorithm (float|double); the
                reference only exposes this for EM via --emprecision
  --shards      shard the EC axis over this many devices (0 = all)

Improvement over the reference kept output-identical: with multiple
groupings the alignment is parsed and collapsed once, not re-read per
grouping (quirk SURVEY.md section 9.9).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import __version__
from .log import Log


CITATION = (
    "Please cite us as:\n"
    "\tMäklin T, Kallonen T, David S et al. High-resolution sweep\n"
    "\tmetagenomics using fast probabilistic inference [version 2;\n"
    "\tpeer review: 2 approved]. Wellcome Open Res 2021, 5:14\n"
    "\t(https://doi.org/10.12688/wellcomeopenres.15639.2)"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="msweep-tpu",
        description=(
            "Estimate abundances of reference lineages in DNA sequencing reads "
            "(mSWEEP on JAX)."
        ),
    )
    p.add_argument("--verbose", action="store_true", help="Print status messages to cerr.")
    p.add_argument("--version", action="store_true", help="Print version.")
    p.add_argument("--cite", action="store_true", help="Print citation information.")

    g = p.add_argument_group("Pseudoalignment files (required: -1 and -2, or only -x; stdin if none)")
    g.add_argument("--themisto-1", help="Pseudoalignments for the 1st strand of paired-end reads.")
    g.add_argument("--themisto-2", help="Pseudoalignments for the 2nd strand of paired-end reads.")
    g.add_argument(
        "--themisto",
        help="Single alignment file or comma-separated list of several files.",
    )

    p.add_argument("-i", dest="indicators", required=False, help="Group indicators for the pseudoalignment reference.")
    p.add_argument("-o", dest="output", default="", help="Prefix for output files (default: print to cout).")

    b = p.add_argument_group("Binning options")
    b.add_argument("--bin-reads", action="store_true", help="Run the mGEMS binning algorithm.")
    b.add_argument("--target-groups", help="Only extract these groups (comma separated list).")
    b.add_argument("--min-abundance", type=float, default=None, help="Only extract groups with relative abundance higher than this.")

    o = p.add_argument_group("Output options")
    o.add_argument("--write-probs", action="store_true", help="Write read-to-group probabilities (_probs.tsv).")
    o.add_argument("--print-probs", action="store_true", help="Print the probabilities to cout.")
    o.add_argument("--write-likelihood", action="store_true", help="Write the likelihood matrix (_likelihoods.tsv).")
    o.add_argument("--write-likelihood-bitseq", action="store_true", help="Write likelihoods in BitSeq-parseable format.")
    o.add_argument("--compress", default="plaintext", help="Compress output files (z, bz2, lzma, zstd).")
    o.add_argument("--compression-level", type=int, default=6, help="Compression level (0-9; default 6).")

    ip = p.add_argument_group("Input options")
    ip.add_argument("--themisto-mode", default="intersection", help="Paired-end merge mode (intersection, union, or unpaired).")
    ip.add_argument("--read-likelihood", help="Path to a likelihood file written with --write-likelihood.")

    e = p.add_argument_group("Estimation options")
    e.add_argument("-t", dest="threads", type=int, default=1, help="Threads for host-side processing (device parallelism is automatic).")
    e.add_argument("--no-fit-model", action="store_true", help="Only build (and optionally write) the likelihood matrix.")
    e.add_argument("--max-iters", type=int, default=5000, help="Maximum optimizer iterations (default 5000).")
    e.add_argument("--tol", type=float, default=1e-6, help="Optimization convergence tolerance (default 1e-6).")
    e.add_argument("--algorithm", default="rcgcpu", help="rcggpu, emgpu, or rcgcpu (default rcgcpu; rcg* are the same XLA program here).")
    e.add_argument("--emprecision", default="double", choices=["float", "double"], help="Precision for the emgpu algorithm (default double).")

    bs = p.add_argument_group("Bootstrapping options")
    bs.add_argument("--iters", type=int, default=0, help="Number of bootstrap rerun iterations (default 0).")
    bs.add_argument("--seed", type=int, default=26012023, help="Seed for the bootstrap RNG (default: random).")
    bs.add_argument("--bootstrap-count", type=int, default=0, help="How many pseudoalignments to resample (default: number of reads).")

    lk = p.add_argument_group("Likelihood options")
    lk.add_argument("-q", dest="q", type=float, default=0.65, help="Mean for the beta-binomial component (default 0.65).")
    lk.add_argument("-e", dest="e", type=float, default=0.01, help="Dispersion term for the beta-binomial component (default 0.01).")
    lk.add_argument("--alphas", help="Prior counts for relative abundances, comma-separated (default all 1.0).")
    lk.add_argument("--zero-inflation", type=float, default=0.01, help="Likelihood of an observation with 0 pseudoalignments against a group (default 0.01).")

    x = p.add_argument_group("Experimental options")
    x.add_argument("--run-rate", action="store_true", help="Calculate RATE/KLD reliability for each estimate.")
    x.add_argument("--min-hits", type=int, default=0, help="Only consider groups with at least this many aligned reads (default 0).")
    x.add_argument("--backend", default=None, help="(extension) force jax platform, e.g. cpu or gpu.")
    x.add_argument("--precision", default=None, choices=["float", "double"], help="(extension) matrix dtype for any algorithm.")
    x.add_argument("--shards", type=int, default=0, help="(extension) shard the EC axis over this many devices (0 = all available).")
    x.add_argument("--write-checkpoint", help="(extension) save the built likelihood problem as a full-precision npz checkpoint.")
    x.add_argument("--read-checkpoint", help="(extension) resume from an npz checkpoint, skipping alignment ingestion and likelihood build.")
    x.add_argument("--trace-dir", help="(extension) write a jax.profiler trace of the estimation to this directory (view with tensorboard/xprof).")
    x.add_argument(
        "--samples-manifest",
        help="(extension) batch mode: TSV of `output_prefix<TAB>aln1[<TAB>aln2]` "
        "lines; processes every sample in one invocation, reusing the "
        "reference, compiled kernels, and compile cache across samples.",
    )
    x.add_argument(
        "--no-precision-escalation", action="store_true",
        help="(extension) stop rcg at the f32 numerical floor instead of "
        "escalating to float64 past it (faster on ill-conditioned data; "
        "abundances may differ from the double answer by ~1e-3).",
    )
    d = p.add_argument_group(
        "Distributed options (extension; multi-host analog of the "
        "reference's MPI build, docs/compilation.md:40-58 — estimation is "
        "sharded across processes, process 0 does all I/O)"
    )
    d.add_argument("--distributed-coordinator", help="coordinator address host:port shared by all processes.")
    d.add_argument("--distributed-nprocs", type=int, help="total number of processes in the job.")
    d.add_argument("--distributed-process-id", type=int, help="this process's id (0-based; 0 = root).")
    return p


def _setup_jax(args):
    if args.backend:
        os.environ.setdefault("JAX_PLATFORMS", args.backend)
    import jax

    if args.backend:
        jax.config.update("jax_platforms", args.backend)
    # f64 matrices need x64; enable it whenever any double path is possible.
    jax.config.update("jax_enable_x64", True)
    # Persistent compilation cache: repeated CLI invocations on the same
    # problem shape skip the cold compile (the reference has no compile
    # step at all, so cold-start latency is pure regression without it).
    from .utils import setup_compile_cache

    setup_compile_cache()
    if args.distributed_coordinator:
        if args.distributed_nprocs is None or args.distributed_process_id is None:
            raise RuntimeError(
                "--distributed-coordinator requires --distributed-nprocs "
                "and --distributed-process-id"
            )
        from .parallel.mesh import init_distributed

        init_distributed(
            args.distributed_coordinator,
            num_processes=args.distributed_nprocs,
            process_id=args.distributed_process_id,
        )
    return jax


def _matrix_dtype(args, backend: str):
    """Matrix dtype policy.

    Explicit --precision always wins; --emprecision covers the reference's
    EM knob (src/mSWEEP.cpp:129).  Otherwise: float32 on the GPU — the
    fused-kernel fast path, with f64 accumulation carrying convergence
    and the f64 escalation tail (see inference/rcg.py docstring; this
    mirrors the reference whose GPU build IS the fast path,
    src/mSWEEP.cpp:127) — and the reference's float64 on the CPU, the
    test reference, where parity with the reference double runs matters
    more than speed.
    """
    import jax.numpy as jnp

    if args.precision:
        return jnp.float32 if args.precision == "float" else jnp.float64
    if args.algorithm == "emgpu" and args.emprecision == "float":
        return jnp.float32
    if backend == "gpu":
        return jnp.float32
    return jnp.float64  # reference default: double everywhere


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = Log(verbose=args.verbose)
    log(f"msweep-tpu-{__version__} abundance estimation")

    if args.version:
        print(f"msweep-tpu-{__version__}", file=sys.stderr)
    if args.cite:
        print(CITATION, file=sys.stderr)
    if args.version or args.cite:
        return 0

    if not args.indicators:
        print("Error in parsing arguments:\n  -i is required\nexiting", file=sys.stderr)
        return 1

    # Output directory must exist (src/mSWEEP.cpp:233-238).
    if "/" in args.output:
        outdir = args.output[: args.output.rfind("/")]
        if not os.path.isdir(outdir):
            print(
                f"Error in parsing arguments:\n  directory {outdir} does not exist\nexiting",
                file=sys.stderr,
            )
            return 1

    alignment_paths: list[str] = []
    if args.themisto:
        alignment_paths = args.themisto.split(",")
    elif args.themisto_1 and args.themisto_2:
        alignment_paths = [args.themisto_1, args.themisto_2]

    try:
        return _run(args, alignment_paths, log)
    except Exception as e:  # fail-fast with message, like finalize()
        print(f"{type(e).__name__}: {e}\nexiting", file=sys.stderr)
        log.flush()
        return 1


def _run(args, alignment_paths: list[str], log: Log) -> int:
    from .core import binning as binning_mod
    from .core.alignment import collapse
    from .core.likelihood import (
        build_likelihood,
        read_likelihood_msweep,
        write_likelihood_bitseq,
        write_likelihood_msweep,
    )
    from .core.sample import BootstrapResampler, make_sample
    from .io.compressed import read_input_bytes
    from .io.grouping import read_reference
    from .io.outputs import (
        OutfileDesignator,
        write_abundances,
        write_abundances_bootstrap,
        write_abundances_rate,
        write_bin,
        write_probs,
    )
    from .io.themisto import merge_strands, parse_plaintext_pairs
    from .io.packed import looks_packed, parse_packed_pairs

    log("Reading the input files")
    log("  reading group indicators")
    reference = read_reference(args.indicators)
    n_groupings = reference.n_groupings
    if n_groupings > 1:
        log(f"  read {n_groupings} groupings")
    log(f"  read {reference.n_refs} group indicators")

    jax = _setup_jax(args)
    is_root = jax.process_index() == 0
    if not is_root:
        log.verbose = False  # root-only logging (reference include/log.hpp:41-46)
    out = OutfileDesignator(
        args.output, n_groupings, args.compress, args.compression_level, root=is_root
    )
    backend = jax.default_backend()
    dtype = _matrix_dtype(args, backend)
    if backend == "gpu" and dtype == jax.numpy.float32 and not args.precision:
        log(
            "  using float32 matrices with float64 accumulation (GPU fast "
            "path); pass --precision double for reference double precision"
        )

    from .inference import (
        dirichlet_kld_from_pseudocounts,
        fit_result,
        pack_problem,
        rates_from_log_kld,
    )
    from .inference.rcg import fit_rcg_batch
    from .inference.em import fit_em_batch
    from .parallel.mesh import make_ec_mesh, to_host

    bootstrap_mode = args.iters > 0
    bin_reads_mode = args.bin_reads

    def run_one_sample(out, sample_paths):
        """Per-sample pipeline (alignment -> fit -> outputs), shared by
        the single-sample path and the --samples-manifest batch mode.
        In batch mode the compiled executables, the reference/grouping,
        and the persistent compile cache are reused across samples —
        the reference re-launches its whole binary per sample."""
        aln = None
        resume = bool(args.read_likelihood or args.read_checkpoint)
        if not resume:
            log("  reading pseudoalignments")
            strands = []
            n_reads = 0
            if sample_paths:
                buffers = [read_input_bytes(p) for p in sample_paths]
            else:
                buffers = [sys.stdin.buffer.read()]
            for buf in buffers:
                if looks_packed(buf):
                    r, t, n = parse_packed_pairs(buf, reference.n_refs)
                else:
                    r, t, n = parse_plaintext_pairs(buf, args.threads)
                strands.append((r, t))
                n_reads = n  # overwritten per strand like the reference (quirk 9.4)
            keys = merge_strands(strands, reference.n_refs, args.themisto_mode)
            log(f"  read alignments for {n_reads} reads")
            log("Building equivalence classes")
            aln = collapse(keys, reference.n_refs, n_reads)
            log(f"  found {aln.n_ecs} unique alignments")
        elif n_groupings > 1:
            raise RuntimeError(
                "Using more than one grouping with --read-likelihood is not yet implemented."
            )

        if args.read_checkpoint and bin_reads_mode:
            raise RuntimeError("--read-checkpoint is incompatible with --bin-reads")

        mesh = make_ec_mesh(args.shards) if args.shards != 1 else None

        for gi in range(n_groupings):
            grouping = reference.groupings[gi]

            if args.read_checkpoint:
                log("  reading likelihood checkpoint")
                from .io.checkpoint import load_checkpoint

                lik, ckpt_names = load_checkpoint(args.read_checkpoint)
                if lik.n_groups_total != grouping.n_groups:
                    raise RuntimeError(
                        f"checkpoint has {lik.n_groups_total} groups but the "
                        f"grouping file has {grouping.n_groups}"
                    )
                sample = make_sample(lik.ec_counts, int(lik.ec_counts.sum()))
            elif args.read_likelihood:
                log("  reading likelihoods from file")
                lik = read_likelihood_msweep(
                    read_input_bytes(args.read_likelihood), grouping.n_groups
                )
                sample = make_sample(lik.ec_counts, int(lik.ec_counts.sum()))
            else:
                log("Computing the likelihood matrix")
                lik = build_likelihood(
                    aln,
                    grouping.indicators,
                    grouping.sizes,
                    q=args.q,
                    e=args.e,
                    min_hits=args.min_hits,
                    zero_inflation=args.zero_inflation,
                )
                sample = make_sample(aln.ec_counts, aln.n_reads)

            if args.write_checkpoint:
                log("  writing likelihood checkpoint")
                from .io.checkpoint import save_checkpoint

                path = args.write_checkpoint
                if n_groupings > 1:
                    path = f"{path}.{gi}" if gi else path
                save_checkpoint(path, lik, grouping.names)

            if args.write_likelihood or args.write_likelihood_bitseq:
                fmt_name = "bitseq" if args.write_likelihood_bitseq else "mSWEEP"
                stream = out.likelihoods(fmt_name)
                if fmt_name == "bitseq":
                    write_likelihood_bitseq(lik, stream)
                else:
                    write_likelihood_msweep(lik, stream)
                if stream is not sys.stdout:
                    stream.close()

            mask = lik.groups_mask
            estimated_names = [n for n, m in zip(grouping.names, mask) if m]
            zero_names = [n for n, m in zip(grouping.names, mask) if not m] if args.min_hits > 0 else []

            if args.no_fit_model:
                log("Skipping relative abundance estimation (--no-fit-model toggled)")
                if gi < n_groupings - 1:
                    out.next_grouping()
                continue

            log("Estimating relative abundances")
            alpha = None
            if args.alphas:
                alpha = np.array([float(v) for v in args.alphas.split(",")], dtype=np.float64)

            problem = pack_problem(lik, alpha=alpha, dtype=dtype, mesh=mesh)
            import contextlib
            import time as _time

            trace_ctx = (
                jax.profiler.trace(args.trace_dir)
                if args.trace_dir
                else contextlib.nullcontext()
            )
            t_fit = _time.time()
            with trace_ctx:
                res = fit_result(
                    problem,
                    args.algorithm,
                    tol=args.tol,
                    max_iters=args.max_iters,
                    verbose=args.verbose,
                    log=log,
                    refine=not args.no_precision_escalation,
                )
                jax.block_until_ready(res.theta)
            t_fit = _time.time() - t_fit
            n_iters = res.n_iters
            n_it = max(int(n_iters), 1)
            log(
                f"  optimizer finished after {int(n_iters)} iterations "
                f"({t_fit:.2f}s, {n_it / t_fit:.2f} it/s)"
            )
            if args.trace_dir:
                log(f"  wrote profiler trace to {args.trace_dir}")

            if args.run_rate:
                print(
                    "WARNING: --run-rate is an experimental option that has not been "
                    "thoroughly tested and is subject to change.\n",
                    file=sys.stderr,
                )
                # O(G): pseudo-counts a = N - alpha fall out of the optimizer
                # state; no gamma matrix is needed (src/Sample.cpp:99-131
                # rebuilds `a` from the probs matrix instead).
                log_klds = dirichlet_kld_from_pseudocounts(res.pseudocounts)
                sample.log_klds = to_host(log_klds)[: problem.n_groups]
                rates = rates_from_log_kld(log_klds, problem.group_mask())
                sample.rates = to_host(rates)[: problem.n_groups]

            if args.min_hits > 0:
                print(
                    "WARNING: --min-hits > 0 is an experimental option that has not been "
                    "thoroughly tested and is subject to change.\n",
                    file=sys.stderr,
                )

            theta = to_host(res.theta)[: problem.n_groups]
            sample.abundances = theta
            # The (E, G) probability matrix is materialized ONLY when an
            # output actually consumes it (probs files / binning) — a plain
            # abundance run stays O(G) beyond logL itself, unlike the
            # reference which always holds the full matrix
            # (src/mSWEEP.cpp:402-423).
            gamma_host = None
            if args.print_probs or args.write_probs or bin_reads_mode:
                gamma_host = to_host(res.gamma())[: problem.n_ecs, : problem.n_groups]
                sample.gamma = gamma_host

            # Binning (before bootstrap, like src/mSWEEP.cpp:437-469).
            if bin_reads_mode:
                if args.read_likelihood:
                    raise RuntimeError("--bin-reads can't be used with --read-likelihood")
                if args.target_groups:
                    target_names = args.target_groups.split(",")
                else:
                    target_names = list(estimated_names)
                if args.min_abundance is not None:
                    target_names = binning_mod.filter_target_groups(
                        estimated_names, theta, args.min_abundance, target_names
                    )
                bins = binning_mod.bin_reads(aln, gamma_host, theta, estimated_names, target_names)
                for name in target_names:
                    stream = out.bin(name)
                    write_bin(stream, bins[name])
                    stream.close()

            if args.print_probs and out.root:
                write_probs(sys.stdout, estimated_names, gamma_host, zero_names)
            if args.write_probs:
                stream = out.probs()
                write_probs(stream, estimated_names, gamma_host, zero_names)
                stream.close()

            # Bootstrap replicates: vmapped batch over resampled count vectors
            # sharing one likelihood matrix (replaces the reference's serial
            # refit loop at src/mSWEEP.cpp:496-518).
            if bootstrap_mode:
                log(f"Running estimation with {args.iters} bootstrap iterations")
                seed = args.seed
                if jax.process_count() > 1:
                    # Every process must draw the SAME replicate batch (the
                    # reference's MPI-era design ran all estimation modes
                    # through the one rank-sharded path with root-only I/O,
                    # docs/compilation.md:40-58).  The sentinel seed means
                    # "random": root draws it and broadcasts.
                    from .core.sample import SEED_SENTINEL

                    if seed == SEED_SENTINEL:
                        from jax.experimental import multihost_utils

                        local = np.asarray(
                            [np.random.default_rng().integers(0, 2**31 - 1)], np.int64
                        )
                        seed = int(multihost_utils.broadcast_one_to_all(local)[0])
                resampler = BootstrapResampler(
                    lik.ec_counts, bootstrap_count=args.bootstrap_count, seed=seed
                )
                batch = resampler.resample_batch(args.iters)
                e_pad = problem.counts.shape[0]
                batch_padded = np.zeros((args.iters, e_pad))
                batch_padded[:, : lik.n_ecs] = batch
                import jax.numpy as jnp

                batch_dev = jnp.asarray(batch_padded, dtype=problem.counts.dtype)
                alg = {"rcgcpu": "rcg", "rcggpu": "rcg", "emgpu": "em"}.get(
                    args.algorithm, args.algorithm
                )
                batch_fit = fit_rcg_batch if alg == "rcg" else fit_em_batch
                # Batch fits return abundances directly ((B, G_pad) theta):
                # no (B, E, G) gamma batch is ever materialized.
                tb, ib, _ = batch_fit(problem, batch_dev, tol=args.tol, max_iters=args.max_iters)
                tb_host = np.asarray(tb)[:, : problem.n_groups]
                sample.bootstrap_results = [theta] + [tb_host[k] for k in range(args.iters)]

            # Write relative abundances.
            stream = out.abundances()
            if sample.rate_run:
                write_abundances_rate(
                    stream,
                    estimated_names,
                    theta,
                    sample.rates,
                    sample.log_klds,
                    sample.n_reads,
                    sample.counts_total,
                    zero_names,
                )
            elif bootstrap_mode:
                write_abundances_bootstrap(
                    stream,
                    estimated_names,
                    sample.bootstrap_results,
                    sample.n_reads,
                    sample.counts_total,
                    zero_names,
                )
            else:
                write_abundances(
                    stream,
                    estimated_names,
                    theta,
                    sample.n_reads,
                    sample.counts_total,
                    zero_names,
                )
            if stream is not sys.stdout:
                stream.close()

            if gi < n_groupings - 1:
                out.next_grouping()

    if args.samples_manifest:
        if sum(1 for p in (args.themisto, args.themisto_1, args.read_likelihood,
                           args.read_checkpoint) if p):
            raise RuntimeError(
                "--samples-manifest is incompatible with --themisto*, "
                "--read-likelihood and --read-checkpoint"
            )
        samples = _manifest_samples(args.samples_manifest)
        log(f"Batch mode: {len(samples)} samples from {args.samples_manifest}")
        for si, (prefix, paths) in enumerate(samples):
            log(f"Sample {si + 1}/{len(samples)}: {prefix}")
            if "/" in prefix and not os.path.isdir(prefix[: prefix.rfind("/")]):
                raise RuntimeError(
                    f"directory {prefix[: prefix.rfind('/')]} does not exist"
                )
            out_s = OutfileDesignator(
                prefix, n_groupings, args.compress, args.compression_level,
                root=is_root,
            )
            run_one_sample(out_s, paths)
    else:
        run_one_sample(out, alignment_paths)

    log.flush()
    return 0


def _manifest_samples(path: str) -> list[tuple[str, list[str]]]:
    """Parse a --samples-manifest TSV: `output_prefix<TAB>aln1[<TAB>aln2]`
    per line (blank lines and #-comments skipped)."""
    rows: list[tuple[str, list[str]]] = []
    with open(path) as f:
        for ln_no, ln in enumerate(f, 1):
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split("\t")
            if len(parts) not in (2, 3):
                raise ValueError(
                    f"samples manifest line {ln_no}: expected "
                    f"prefix<TAB>aln1[<TAB>aln2], got {len(parts)} fields"
                )
            rows.append((parts[0], parts[1:]))
    if not rows:
        raise ValueError("samples manifest contains no samples")
    return rows


if __name__ == "__main__":
    sys.exit(main())
