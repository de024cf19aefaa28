"""End-to-end CLI tests (SURVEY.md section 6 tier 3): the docs-example workflow
on synthetic data, exercising every output path."""

import os

import numpy as np
import pytest

from msweep_tpu.cli import main


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Synthetic 4-cluster dataset shaped like the Zenodo toy example
    (docs/example.md): 12 refs in 4 clusters, 600 paired reads."""
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(123)
    clusters = ["clust1"] * 4 + ["clust2"] * 3 + ["clust3"] * 3 + ["clust4"] * 2
    (d / "clustering.txt").write_text("\n".join(clusters) + "\n")
    members = {0: range(0, 4), 1: range(4, 7), 2: range(7, 10), 3: range(10, 12)}
    theta = [0.5, 0.3, 0.15, 0.05]
    fwd, rev = [], []
    for rid in range(600):
        lin = rng.choice(4, p=theta)
        tg = sorted({t for t in members[lin] if rng.random() < 0.85})
        tg2 = sorted({t for t in tg if rng.random() < 0.95})
        fwd.append(f"{rid} " + " ".join(map(str, tg)) if tg else str(rid))
        rev.append(f"{rid} " + " ".join(map(str, tg2)) if tg2 else str(rid))
    (d / "s1.txt").write_text("\n".join(fwd) + "\n")
    (d / "s2.txt").write_text("\n".join(rev) + "\n")
    return d


def base_args(dataset, outdir, extra=()):
    return [
        "--themisto-1", str(dataset / "s1.txt"),
        "--themisto-2", str(dataset / "s2.txt"),
        "-i", str(dataset / "clustering.txt"),
        "-o", str(outdir / "215"),
        *extra,
    ]


def read_abundances(path):
    names, thetas = [], []
    headers = {}
    for line in open(path):
        if line.startswith("#"):
            parts = line.strip().split("\t")
            headers[parts[0]] = parts[1] if len(parts) > 1 else None
            continue
        parts = line.strip().split("\t")
        names.append(parts[0])
        thetas.append(float(parts[1]))
    return names, np.array(thetas), headers


def test_default_run(dataset, tmp_path):
    assert main(base_args(dataset, tmp_path)) == 0
    names, theta, headers = read_abundances(tmp_path / "215_abundances.txt")
    assert names == ["clust1", "clust2", "clust3", "clust4"]
    assert "#mSWEEP_version:" in headers
    assert int(headers["#num_reads:"]) == 600
    assert 0 < int(headers["#num_aligned:"]) <= 600
    assert theta.sum() == pytest.approx(1.0, abs=1e-4)
    assert theta[0] == pytest.approx(0.5, abs=0.07)
    assert theta[3] == pytest.approx(0.05, abs=0.05)


def test_stdout_run(dataset, capsys):
    args = base_args(dataset, type("o", (), {"__truediv__": lambda s, x: ""})())
    args = [a for a in args]
    # rebuild with empty -o
    i = args.index("-o")
    args[i + 1] = ""
    assert main(args) == 0
    outtext = capsys.readouterr().out
    assert "#c_id\tmean_theta" in outtext
    assert "clust1\t" in outtext


def test_em_algorithm_agrees(dataset, tmp_path):
    assert main(base_args(dataset, tmp_path)) == 0
    _, t_rcg, _ = read_abundances(tmp_path / "215_abundances.txt")
    assert main(base_args(dataset, tmp_path, ["--algorithm", "emgpu", "--tol", "1e-10"])) == 0
    _, t_em, _ = read_abundances(tmp_path / "215_abundances.txt")
    np.testing.assert_allclose(t_rcg, t_em, atol=1e-3)


def test_emprecision_float(dataset, tmp_path):
    assert main(base_args(dataset, tmp_path, ["--algorithm", "emgpu", "--emprecision", "float"])) == 0
    _, theta, _ = read_abundances(tmp_path / "215_abundances.txt")
    assert theta.sum() == pytest.approx(1.0, abs=1e-3)


def test_write_probs(dataset, tmp_path):
    assert main(base_args(dataset, tmp_path, ["--write-probs"])) == 0
    lines = open(tmp_path / "215_probs.tsv").read().splitlines()
    header = lines[0].split("\t")
    assert header == ["ec_id", "clust1", "clust2", "clust3", "clust4"]
    row0 = lines[1].split("\t")
    assert row0[0] == "0"
    probs = np.array([float(v) for v in row0[1:]])
    assert probs.sum() == pytest.approx(1.0, abs=1e-4)
    # data rows + header + trailing blank line from std::endl reproduction
    assert lines[-1] == ""


def test_bootstrap(dataset, tmp_path):
    assert main(base_args(dataset, tmp_path, ["--iters", "4", "--seed", "7"])) == 0
    path = tmp_path / "215_abundances.txt"
    text = open(path).read()
    assert "#bootstrap_iters:\t4" in text
    rows = [l.split("\t") for l in text.splitlines() if not l.startswith("#")]
    assert all(len(r) == 6 for r in rows)  # name, mean, 4 iters
    boots = np.array([[float(v) for v in r[1:]] for r in rows])
    assert np.allclose(boots.sum(axis=0), 1.0, atol=1e-3)
    # seeded run reproduces exactly
    assert main(base_args(dataset, tmp_path, ["--iters", "4", "--seed", "7"])) == 0
    assert open(path).read() == text


def test_bin_reads(dataset, tmp_path):
    assert main(base_args(dataset, tmp_path, ["--bin-reads"])) == 0
    for c in ["clust1", "clust2", "clust3", "clust4"]:
        p = tmp_path / f"{c}.bin"
        assert p.exists()
    ids = [int(x) for x in open(tmp_path / "clust1.bin").read().split()]
    assert ids == sorted(ids)
    assert all(0 <= i < 600 for i in ids)
    # big clusters get plenty of reads
    assert len(ids) > 100


def test_bin_reads_target_and_min_abundance(dataset, tmp_path):
    assert main(
        base_args(dataset, tmp_path, ["--bin-reads", "--min-abundance", "0.1"])
    ) == 0
    assert (tmp_path / "clust1.bin").exists()
    assert not (tmp_path / "clust4.bin").exists()  # theta ~0.05 filtered


def test_likelihood_roundtrip(dataset, tmp_path):
    assert main(base_args(dataset, tmp_path, ["--write-likelihood"])) == 0
    _, t1, _ = read_abundances(tmp_path / "215_abundances.txt")
    lik_file = tmp_path / "215_likelihoods.tsv"
    assert lik_file.exists()
    out2 = tmp_path / "resume"
    os.mkdir(out2)
    assert main([
        "--read-likelihood", str(lik_file),
        "-i", str(dataset / "clustering.txt"),
        "-o", str(out2 / "215"),
    ]) == 0
    _, t2, _ = read_abundances(out2 / "215_abundances.txt")
    np.testing.assert_allclose(t1, t2, atol=2e-5)  # 6-sigdigit file precision


def test_no_fit_model(dataset, tmp_path):
    assert main(base_args(dataset, tmp_path, ["--no-fit-model", "--write-likelihood"])) == 0
    assert (tmp_path / "215_likelihoods.tsv").exists()
    assert not (tmp_path / "215_abundances.txt").exists()


def test_run_rate(dataset, tmp_path):
    assert main(base_args(dataset, tmp_path, ["--run-rate"])) == 0
    text = open(tmp_path / "215_abundances.txt").read()
    assert "#c_id\tmean_theta\tRATE\tKLD" in text
    rows = [l.split("\t") for l in text.splitlines() if not l.startswith("#")]
    rates = np.array([float(r[2]) for r in rows])
    assert rates.sum() == pytest.approx(1.0, abs=1e-4)


def test_min_hits(dataset, tmp_path):
    # Absurd threshold masks every group: the file is still written, with
    # an explicit zero row per group (write_abundances2 semantics,
    # src/PlainSample.cpp:48-71 re-expands masked groups as zeros).
    assert main(base_args(dataset, tmp_path, ["--min-hits", "100000"])) == 0
    names, theta, _ = read_abundances(tmp_path / "215_abundances.txt")
    assert set(names) == {"clust1", "clust2", "clust3", "clust4"}
    assert (theta == 0).all()
    # Threshold 30 masks only the rare clust4 (~5% of 600 reads): its row
    # is an exact zero, the surviving groups renormalize to 1.
    assert main(base_args(dataset, tmp_path, ["--min-hits", "30"])) == 0
    names, theta, _ = read_abundances(tmp_path / "215_abundances.txt")
    assert len(names) == 4  # all four clusters listed (zeros appended)
    assert theta[names.index("clust4")] == 0.0
    kept = [t for n, t in zip(names, theta) if n != "clust4"]
    assert all(t > 0 for t in kept)
    assert sum(kept) == pytest.approx(1.0, abs=1e-4)
    # estimated groups come first, masked zero rows are appended
    assert names[:3] == ["clust1", "clust2", "clust3"]


def test_multi_grouping(dataset, tmp_path):
    # two groupings: the 4-cluster one and a coarse 2-cluster one
    coarse = {"clust1": "A", "clust2": "A", "clust3": "B", "clust4": "B"}
    lines = [
        f"{c}\t{coarse[c]}"
        for c in open(dataset / "clustering.txt").read().split()
    ]
    two = tmp_path / "two.txt"
    two.write_text("\n".join(lines) + "\n")
    args = base_args(dataset, tmp_path)
    args[args.index("-i") + 1] = str(two)
    assert main(args) == 0
    n0, t0, _ = read_abundances(tmp_path / "215_0_abundances.txt")
    n1, t1, _ = read_abundances(tmp_path / "215_1_abundances.txt")
    assert n0 == ["clust1", "clust2", "clust3", "clust4"]
    assert n1 == ["A", "B"]
    assert t1[0] == pytest.approx(t0[0] + t0[1], abs=0.02)


def test_compress_probs(dataset, tmp_path):
    import gzip

    assert main(base_args(dataset, tmp_path, ["--write-probs", "--compress", "z"])) == 0
    # abundances never compressed (quirk 9.8); probs are
    assert (tmp_path / "215_abundances.txt").exists()
    with gzip.open(tmp_path / "215_probs.tsv.gz", "rt") as f:
        assert f.readline().startswith("ec_id\t")


def test_packed_input(dataset, tmp_path):
    from msweep_tpu.io.packed import pack_pairs
    from msweep_tpu.io.themisto import parse_plaintext_pairs

    n_refs = 12
    for s in ["s1", "s2"]:
        r, t, n = parse_plaintext_pairs(open(dataset / f"{s}.txt", "rb").read())
        (tmp_path / f"{s}.aln").write_bytes(pack_pairs(r, t, n, n_refs))
    assert main(base_args(dataset, tmp_path)) == 0
    _, t_plain, _ = read_abundances(tmp_path / "215_abundances.txt")
    args = base_args(dataset, tmp_path)
    args[args.index("--themisto-1") + 1] = str(tmp_path / "s1.aln")
    args[args.index("--themisto-2") + 1] = str(tmp_path / "s2.aln")
    assert main(args) == 0
    _, t_packed, _ = read_abundances(tmp_path / "215_abundances.txt")
    np.testing.assert_allclose(t_plain, t_packed, atol=1e-12)


def test_alphas_wrong_length_fails(dataset, tmp_path, capsys):
    rc = main(base_args(dataset, tmp_path, ["--alphas", "1,1"]))
    assert rc == 1
    assert "alphas" in capsys.readouterr().err


def test_missing_outdir_fails(dataset):
    rc = main([
        "--themisto-1", str(dataset / "s1.txt"),
        "--themisto-2", str(dataset / "s2.txt"),
        "-i", str(dataset / "clustering.txt"),
        "-o", "/nonexistent_dir_xyz/215",
    ])
    assert rc == 1


def test_pack_cli_roundtrip(tmp_path, capsys):
    # plaintext -> packed -> plaintext round trip via the standalone codec
    # CLI (the alignment-writer binary equivalent).
    from msweep_tpu import cli_pack

    src = tmp_path / "a.txt"
    src.write_text("0 1 3\n1\n2 0 1 2\n")
    import sys, io
    old = sys.stdout
    try:
        sys.stdout = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
        cli_pack.main(["pack", "-n", "4", str(src)])
        sys.stdout.flush()
        packed_bytes = sys.stdout.buffer.getvalue()
    finally:
        sys.stdout = old
    aln = tmp_path / "a.aln"
    aln.write_bytes(packed_bytes)
    assert packed_bytes.split(b"\n", 1)[0] == b"3,4"

    try:
        sys.stdout = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
        cli_pack.main(["unpack", str(aln)])
        sys.stdout.flush()
        text = sys.stdout.buffer.getvalue().decode()
    finally:
        sys.stdout = old
    assert text == "0 1 3\n1\n2 0 1 2\n"


def test_checkpoint_roundtrip(tmp_path):
    import numpy as np
    from msweep_tpu.core.alignment import collapse
    from msweep_tpu.core.likelihood import build_likelihood
    from msweep_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from msweep_tpu.io.themisto import merge_strands

    r = np.array([0, 0, 1, 2, 2, 2], dtype=np.uint64)
    t = np.array([0, 1, 2, 0, 1, 3], dtype=np.uint64)
    keys = merge_strands([(r, t)], 4, "intersection")
    aln = collapse(keys, 4, 3)
    ind = np.array([0, 0, 1, 1])
    lik = build_likelihood(aln, ind, np.array([2, 2]))
    p = tmp_path / "ck.npz"
    save_checkpoint(str(p), lik, ["a", "b"])
    lik2, names = load_checkpoint(str(p))
    assert names == ["a", "b"]
    np.testing.assert_allclose(lik2.dense(), lik.dense())
    np.testing.assert_array_equal(lik2.ec_counts, lik.ec_counts)
    assert lik2.n_groups == lik.n_groups
    assert lik2._dense is None  # stored in its sparse build form


def test_checkpoint_roundtrip_dense(tmp_path):
    """A likelihood read from a file has no sparse form: the checkpoint
    keeps its dense matrix, at full precision."""
    import numpy as np
    from msweep_tpu.core.likelihood import Likelihood
    from msweep_tpu.io.checkpoint import load_checkpoint, save_checkpoint

    rng = np.random.default_rng(0)
    dense = np.log(rng.dirichlet(np.ones(3), size=5))
    lik = Likelihood(
        n_ecs=5, n_groups_total=3, groups_mask=np.ones(3, bool),
        group_sizes=np.zeros(3, np.int64), ec_counts=np.arange(1, 6),
        zero_inflation=0.01, _dense=dense,
    )
    p = tmp_path / "ck.npz"
    save_checkpoint(str(p), lik, ["a", "b", "c"])
    lik2, names = load_checkpoint(str(p))
    assert names == ["a", "b", "c"]
    np.testing.assert_array_equal(lik2.dense(), dense)
    np.testing.assert_array_equal(lik2.ec_counts, lik.ec_counts)


def test_dtype_and_impl_selection(monkeypatch):
    """Pin the fast-path policy: a plain GPU run gets f32 matrices and the
    fused kernel impl; CPU and explicit --precision double stay f64."""
    import jax
    import jax.numpy as jnp

    from msweep_tpu.cli import build_parser, _matrix_dtype
    from msweep_tpu.inference.rcg import choose_impl
    from msweep_tpu.parallel.mesh import make_ec_mesh

    p = build_parser()
    default = p.parse_args(["-i", "x"])
    assert _matrix_dtype(default, "gpu") == jnp.float32
    assert _matrix_dtype(default, "cpu") == jnp.float64
    forced = p.parse_args(["-i", "x", "--precision", "double"])
    assert _matrix_dtype(forced, "gpu") == jnp.float64
    em_float = p.parse_args(["-i", "x", "--algorithm", "emgpu", "--emprecision", "float"])
    assert _matrix_dtype(em_float, "cpu") == jnp.float32
    em_default = p.parse_args(["-i", "x", "--algorithm", "emgpu"])
    assert _matrix_dtype(em_default, "gpu") == jnp.float32

    # impl choice: pallas iff GPU backend + f32 + kernel-compatible shape
    f32 = jnp.zeros((64, 128), jnp.float32)
    f64 = jnp.zeros((64, 128), jnp.float64)
    impl, why = choose_impl(f32)
    assert impl == "xla" and "cpu" in why  # CPU backend in tests
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert choose_impl(f32)[0] == "pallas"
    assert choose_impl(f32, make_ec_mesh(4))[0] == "pallas"
    # f64 on the GPU uses the implicit XLA-f64 step (O(G) state).
    assert choose_impl(f64)[0] == "xla64"
    # Rows wider than the kernel holds: the implicit f64 step, with why.
    impl, why = choose_impl(jnp.zeros((8, 8192), jnp.float32))
    assert impl == "xla64" and "8192" in why


@pytest.mark.parametrize("backend,algorithm,expect", [
    ("gpu", "rcgcpu", "impl=pallas (fused Triton passes)"),
    ("gpu", "emgpu", "impl=pallas (fused Triton passes)"),
    ("cpu", "rcgcpu", "impl=xla (explicit reference step on cpu)"),
])
def test_impl_log_line(monkeypatch, backend, algorithm, expect):
    """The CLI's impl= log line names the choice and the reason for it;
    the choice itself is never an interpret-mode impl."""
    import jax
    import jax.numpy as jnp

    from msweep_tpu.inference import _log_impl
    from msweep_tpu.inference.pack import DeviceProblem

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    prob = DeviceProblem(
        logL=jnp.zeros((64, 128), jnp.float32), counts=jnp.ones(64),
        alpha=jnp.ones(128), n_ecs=64, n_groups=128, bound_const=0.0,
    )
    lines = []
    name = {"rcgcpu": "rcg", "emgpu": "em"}[algorithm]
    _log_impl(lines.append, name, prob)
    assert expect in lines[0]
    assert "interpret" not in lines[0]


def test_samples_manifest_batch(dataset, tmp_path):
    """--samples-manifest processes several samples in one invocation,
    each matching its individually-run output byte-for-byte."""
    manifest = tmp_path / "manifest.tsv"
    manifest.write_text(
        f"{tmp_path}/batchA\t{dataset}/s1.txt\t{dataset}/s2.txt\n"
        "# a comment line\n"
        f"{tmp_path}/batchB\t{dataset}/s1.txt\n"
    )
    assert main([
        "--samples-manifest", str(manifest),
        "-i", str(dataset / "clustering.txt"),
    ]) == 0
    # individual runs for comparison
    assert main([
        "--themisto-1", str(dataset / "s1.txt"),
        "--themisto-2", str(dataset / "s2.txt"),
        "-i", str(dataset / "clustering.txt"),
        "-o", str(tmp_path / "soloA"),
    ]) == 0
    assert main([
        "--themisto", str(dataset / "s1.txt"),
        "-i", str(dataset / "clustering.txt"),
        "-o", str(tmp_path / "soloB"),
    ]) == 0
    a_batch = (tmp_path / "batchA_abundances.txt").read_text()
    a_solo = (tmp_path / "soloA_abundances.txt").read_text()
    assert a_batch == a_solo
    b_batch = (tmp_path / "batchB_abundances.txt").read_text()
    b_solo = (tmp_path / "soloB_abundances.txt").read_text()
    assert b_batch == b_solo
    assert a_batch != b_batch  # strand intersection really differed


def test_samples_manifest_incompatible_flags(dataset, tmp_path, capsys):
    manifest = tmp_path / "m.tsv"
    manifest.write_text(f"{tmp_path}/x\t{dataset}/s1.txt\n")
    rc = main([
        "--samples-manifest", str(manifest),
        "--themisto", str(dataset / "s1.txt"),
        "-i", str(dataset / "clustering.txt"),
    ])
    assert rc == 1
    assert "incompatible" in capsys.readouterr().err


def test_samples_manifest_bad_line_fails(dataset, tmp_path, capsys):
    manifest = tmp_path / "m.tsv"
    manifest.write_text("onlyprefix\n")
    rc = main([
        "--samples-manifest", str(manifest),
        "-i", str(dataset / "clustering.txt"),
    ])
    assert rc == 1
    assert "manifest" in capsys.readouterr().err
