#!/bin/bash
# Reference-default production workload: hg38 diploid at 100 kb/bead,
# full cycle with the 700k-step G1 (BASELINE.md targets).
# Run from the root of the checkout.
T=runs/prod.h5
L () { echo "[pipeline $(date +%H:%M:%S)] $*"; }
set -o pipefail
if [ ! -f "$T" ]; then
  L prepare
  timeout 600 python -m genome_cycle_tpu.cli prepare -s 1 -o "$T" \
    examples/config_production.json examples/hg38_chains_100kb.tsv || exit 1
  L anatelophase
  timeout 3600 python -m genome_cycle_tpu.cli anatelophase "$T" || exit 1
  L transition
  timeout 1800 python -m genome_cycle_tpu.cli transition interphase "$T" || exit 1
fi
L interphase
for try in 1 2 3 4 5 6 7 8; do
  timeout 18000 python -m genome_cycle_tpu.cli interphase "$T" && ok=1 && break
  L "interphase attempt $try exited nonzero; resuming from checkpoint"
  sleep 5
done
[ "$ok" = 1 ] || exit 1
L transition-prometaphase
timeout 1800 python -m genome_cycle_tpu.cli transition prometaphase "$T" || exit 1
L prometaphase
timeout 7200 python -m genome_cycle_tpu.cli prometaphase "$T" || exit 1
L done
