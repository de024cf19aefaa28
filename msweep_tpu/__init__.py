"""msweep-tpu: a bacterial community composition engine on JAX.

A from-scratch reimplementation of the capabilities of PROBIC/mSWEEP
(the reference, see SURVEY.md), run on NVIDIA GPUs:

- Host side (numpy): streaming ingestion of Themisto pseudoalignments,
  equivalence-class collapse, grouping metadata, output formatting.
- Device side (JAX/XLA/Pallas): dense log-likelihood matrix in device
  memory, mixture-model inference (Riemannian conjugate-gradient
  variational Bayes, plain EM) as fused Pallas (Triton) kernels on the
  GPU inside `lax.scan` chunks (the explicit XLA step on the CPU),
  bootstrap replicates as vmapped batches, EC-axis sharding across a
  device mesh with psum-merged sufficient statistics.

The reference's layer map (SURVEY.md section 1) maps here as:

  L0/L1 byte + file I/O      -> msweep_tpu.io.compressed
  L2 alignment ingestion     -> msweep_tpu.io.themisto, msweep_tpu.core.alignment
  L3 reference metadata      -> msweep_tpu.io.grouping
  L4 likelihood model        -> msweep_tpu.core.likelihood
  L5 inference engine        -> msweep_tpu.inference (rcg, em, kernels)
  L6 results / sample state  -> msweep_tpu.core.sample
  L7 read binning            -> msweep_tpu.core.binning
  L8 output designation      -> msweep_tpu.io.outputs
  L9 CLI / driver            -> msweep_tpu.cli
  LX logging                 -> msweep_tpu.log
  multi-card (was MPI/OpenMP)-> msweep_tpu.parallel
"""

__version__ = "0.1.0"

# mSWEEP version whose output format / CLI contract we implement
# (reference snapshot is post-v2.2.x, see SURVEY.md header).
REFERENCE_COMPAT_VERSION = "2.2.x"
