#!/usr/bin/env bash
# Write the C/F-interpolation network's checkpoint that the learned Schur
# preconditioner loads (LearnedAMGPreconditioner, option mlamg_pnet_model):
# 60 Adam epochs of amg_loss on the pinned pressure Laplacians of the
# lid-driven cavity at n 8, 10 and 12 (seed 0, dims 8 8 16, K 3), then the
# pressure solves and the Schur round trip at n 14, 16 and 20 in its JSON.
# About 80 s on the CPU.
set -euo pipefail
cd "$(dirname "$0")/.."
mkdir -p runs_cf_interp
python -m mlamg_tpu.cli.train_cf_interp --epochs 60 \
  --checkpoint runs_cf_interp/cf_best.ckpt --out runs_cf_interp/cf_interp.json \
  --platform cpu
