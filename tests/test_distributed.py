"""Tier-4 distributed tests (SURVEY.md section 6): N-process jax.distributed
CPU runs — the analog of the reference's MPI rank-count-invariance
checks (reference docs/compilation.md:40-58).  Each spawned process
owns 2 virtual CPU devices; the 2-process job therefore runs the same
EC-sharded SPMD program as 4 cards, with gloo collectives standing in
for NCCL.  Process 0 does all I/O (root-only semantics)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_data")
    rng = np.random.default_rng(321)
    clusters = ["clust1"] * 4 + ["clust2"] * 3 + ["clust3"] * 3 + ["clust4"] * 2
    (d / "clustering.txt").write_text("\n".join(clusters) + "\n")
    members = {0: range(0, 4), 1: range(4, 7), 2: range(7, 10), 3: range(10, 12)}
    theta = [0.5, 0.3, 0.15, 0.05]
    fwd = []
    for rid in range(400):
        lin = rng.choice(4, p=theta)
        tg = sorted({t for t in members[lin] if rng.random() < 0.85})
        fwd.append(f"{rid} " + " ".join(map(str, tg)) if tg else str(rid))
    (d / "s1.txt").write_text("\n".join(fwd) + "\n")
    return d


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_env(n_devices: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "true"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _base_args(dataset, prefix):
    return [
        sys.executable, "-m", "msweep_tpu.cli",
        "--themisto", str(dataset / "s1.txt"),
        "-i", str(dataset / "clustering.txt"),
        "-o", str(prefix),
        "--write-probs", "--verbose",
        "--backend", "cpu",
    ]


def _run_single(dataset, tmp_path):
    prefix = tmp_path / "single"
    r = subprocess.run(
        _base_args(dataset, prefix) + ["--shards", "1"],
        env=_cli_env(1), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    return prefix, r.stderr


def _run_distributed(dataset, tmp_path, nprocs=2, devices_per_proc=2):
    port = _free_port()
    prefix = tmp_path / "dist"
    procs = []
    for pid in range(nprocs):
        cmd = _base_args(dataset, prefix) + [
            "--distributed-coordinator", f"localhost:{port}",
            "--distributed-nprocs", str(nprocs),
            "--distributed-process-id", str(pid),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=_cli_env(devices_per_proc),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        )
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e
    return prefix, outs


def _read_theta(path):
    names, thetas = [], []
    for line in open(path):
        if line.startswith("#"):
            continue
        n, t = line.split("\t")[:2]
        names.append(n)
        thetas.append(float(t))
    return names, np.array(thetas)


def _iters_from_log(stderr: str) -> int:
    for line in stderr.splitlines():
        if "optimizer finished after" in line:
            return int(line.split("after")[1].split("iterations")[0])
    raise AssertionError(f"no iteration count in log:\n{stderr}")


def test_two_process_run_matches_single(dataset, tmp_path):
    """Process-count invariance of theta, iteration count, and probs."""
    single_prefix, single_log = _run_single(dataset, tmp_path)
    dist_prefix, outs = _run_distributed(dataset, tmp_path)

    names_s, theta_s = _read_theta(str(single_prefix) + "_abundances.txt")
    names_d, theta_d = _read_theta(str(dist_prefix) + "_abundances.txt")
    assert names_s == names_d
    np.testing.assert_allclose(theta_d, theta_s, atol=2e-6)

    # identical iteration counts = same trajectory, not just same optimum
    it_s = _iters_from_log(single_log)
    it_d = _iters_from_log(outs[0][1])
    assert it_s == it_d

    # probs written by root only, equal to the single-process file
    probs_s = open(str(single_prefix) + "_probs.tsv").read()
    probs_d = open(str(dist_prefix) + "_probs.tsv").read()
    assert probs_s == probs_d


def test_nonroot_process_writes_nothing(dataset, tmp_path):
    """Only process 0 writes files and logs (root-only I/O semantics)."""
    dist_prefix, outs = _run_distributed(dataset, tmp_path)
    # root logged verbose lines; non-root logged nothing of ours
    assert "Estimating relative abundances" in outs[0][1]
    assert "Estimating relative abundances" not in outs[1][1]
    assert "optimizer finished" not in outs[1][1]
    # both ran the same program: files exist exactly once, written by root
    assert os.path.exists(str(dist_prefix) + "_abundances.txt")


def test_missing_distributed_args_error(dataset, tmp_path):
    r = subprocess.run(
        _base_args(dataset, tmp_path / "x")
        + ["--distributed-coordinator", "localhost:1"],
        env=_cli_env(1), capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 1
    assert "--distributed-nprocs" in r.stderr


def _run_distributed_args(dataset, tmp_path, extra, nprocs=2, devices_per_proc=2,
                          name="dist_bs"):
    port = _free_port()
    prefix = tmp_path / name
    procs = []
    for pid in range(nprocs):
        cmd = _base_args(dataset, prefix) + extra + [
            "--distributed-coordinator", f"localhost:{port}",
            "--distributed-nprocs", str(nprocs),
            "--distributed-process-id", str(pid),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=_cli_env(devices_per_proc),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        )
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e
    return prefix, outs


def _read_bootstrap_rows(path):
    rows = []
    for line in open(path):
        if line.startswith("#"):
            continue
        parts = line.rstrip("\n").split("\t")
        rows.append((parts[0], np.array([float(x) for x in parts[1:]])))
    return rows


def test_two_process_bootstrap_matches_single(dataset, tmp_path):
    """--iters (bootstrap) in a 2-process sharded run: the seed-pinned
    replicate batch is process-count invariant (the restriction the
    round-3 CLI raised on is lifted; reference MPI design ran every
    estimation mode through the one rank-sharded path,
    docs/compilation.md:40-58)."""
    bs = ["--iters", "4", "--seed", "7"]
    single_prefix = tmp_path / "single_bs"
    r = subprocess.run(
        _base_args(dataset, single_prefix) + bs + ["--shards", "1"],
        env=_cli_env(1), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    dist_prefix, outs = _run_distributed_args(dataset, tmp_path, bs)

    rows_s = _read_bootstrap_rows(str(single_prefix) + "_abundances.txt")
    rows_d = _read_bootstrap_rows(str(dist_prefix) + "_abundances.txt")
    assert [r[0] for r in rows_s] == [r[0] for r in rows_d]
    assert all(len(v) == 5 for _, v in rows_s)  # mean + 4 replicates
    for (_, v_s), (_, v_d) in zip(rows_s, rows_d):
        np.testing.assert_allclose(v_d, v_s, atol=2e-6)
