"""Native array checkpoint of the built likelihood problem.

The reference's only "checkpoint" is the likelihood TSV
(--write-likelihood + --read-likelihood, src/mSWEEP.cpp:356-380); we
keep that format for interop (core/likelihood.py) and add this compact
npz checkpoint (SURVEY.md section 7) holding the likelihood (sparse
build form or dense matrix), EC counts, group metadata and the
--min-hits mask — resuming from it skips alignment ingestion AND the
likelihood build, and unlike the TSV it round-trips at full float
precision.

CLI: `--write-checkpoint x.npz` / `--read-checkpoint x.npz`
(msweep-tpu extensions).
"""

from __future__ import annotations

import numpy as np

FORMAT_VERSION = 2

_SPARSE = ("table", "trip_e", "trip_g", "trip_k")


def save_checkpoint(path: str, lik, group_names: list[str]) -> None:
    """A likelihood built from an alignment is stored in its sparse build
    form (the (G, S+1) table and the hit triplets: about 1/30 of the
    dense bytes at reference scale, and written uncompressed); one read
    from a likelihood file has no such form and stores its dense
    matrix, compressed."""
    from ..core.likelihood import Likelihood

    assert isinstance(lik, Likelihood)
    meta = dict(
        format_version=np.int64(FORMAT_VERSION),
        n_ecs=np.int64(lik.n_ecs),
        ec_counts=lik.ec_counts,
        groups_mask=lik.groups_mask,
        group_sizes=lik.group_sizes,
        n_groups_total=np.int64(lik.n_groups_total),
        zero_inflation=np.float64(lik.zero_inflation),
        group_names=np.array(group_names, dtype=object),
    )
    if lik._dense is None:
        np.savez(path, **meta, **{k: getattr(lik, k) for k in _SPARSE})
    else:
        np.savez_compressed(path, **meta, dense=lik.dense(np.float64))


def load_checkpoint(path: str):
    """Returns (Likelihood, group_names)."""
    from ..core.likelihood import Likelihood

    with np.load(path, allow_pickle=True) as z:
        ver = int(z["format_version"])
        if ver > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {ver} is newer than supported {FORMAT_VERSION}")
        if "dense" in z:
            dense = z["dense"]
            body = dict(n_ecs=dense.shape[0], _dense=dense)
        else:
            body = dict(n_ecs=int(z["n_ecs"]), **{k: z[k] for k in _SPARSE})
        lik = Likelihood(
            n_groups_total=int(z["n_groups_total"]),
            groups_mask=z["groups_mask"],
            group_sizes=z["group_sizes"],
            ec_counts=z["ec_counts"],
            zero_inflation=float(z["zero_inflation"]),
            **body,
        )
        names = [str(s) for s in z["group_names"]]
    return lik, names
