#!/usr/bin/env bash
# Standalone single-device GAN baseline on the PyTorch/CUDA port
# (mdgan_tpu_torch), the counterpart of run-standalone.sh with the same flags
# from shared-args.sh; arguments are passed on to the CLI (e.g. --device cpu).
set -euo pipefail
cd "$(dirname "$0")"
source ./shared-args.sh

python="${PYTHON:-python}"  # the interpreter

exec "$python" -m mdgan_tpu_torch.cli.train \
  --mode standalone \
  --dataset "$dataset" \
  --epochs "$epochs" \
  --local_epochs "$local_epochs" \
  --batch_size "$batch_size" \
  --generator_lr "$generator_lr" \
  --discriminator_lr "$discriminator_lr" \
  --log_interval "$log_interval" \
  --seed "$seed" \
  --beta_1 "$beta_1" \
  --beta_2 "$beta_2" \
  --chunk_size "$chunk_size" \
  --compute_dtype "$compute_dtype" \
  "$@"
