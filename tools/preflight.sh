#!/usr/bin/env bash
# Preflight gate: run before every end-of-round / milestone commit.
#
# A snapshot whose production path crashes on its first call is caught
# by this check: the test suite on the CPU, the end-to-end check on the
# GPU when one is present (the quick bench on the CPU otherwise), and
# the two graft entry points.  All must pass.
#
# Usage:  bash tools/preflight.sh
set -u
cd "$(dirname "$0")/.."
fail=0

step() {
  echo "== preflight: $1" >&2
  shift
  if "$@"; then
    echo "== preflight: OK" >&2
  else
    echo "== preflight: FAILED ($1)" >&2
    fail=1
  fi
}

step "pytest (cpu)" timeout 2400 env JAX_PLATFORMS=cpu python -m pytest tests/ -q

if nvidia-smi >/dev/null 2>&1; then
  step "chip smoke (gpu)" timeout 1200 python chip_smoke.py
else
  step "bench quick (cpu)" timeout 1800 env JAX_PLATFORMS=cpu \
    MSWEEP_BENCH_SUITE=quick MSWEEP_BENCH_E=65536 MSWEEP_BENCH_G=128 \
    python bench.py
fi

step "graft entry (single chip compile)" timeout 900 python -c "
import __graft_entry__ as g, jax
fn, args = g.entry()
jax.jit(fn).lower(*args).compile()
print('entry ok')
"

step "graft dryrun_multichip(8)" timeout 900 env \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  python -c "
import __graft_entry__ as g
g.dryrun_multichip(8)
print('dryrun ok')
"

if [ "$fail" -ne 0 ]; then
  echo "preflight: RED — do not commit a snapshot from this state" >&2
  exit 1
fi
echo "preflight: all green" >&2
