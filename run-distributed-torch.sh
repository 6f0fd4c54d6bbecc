#!/usr/bin/env bash
# MD-GAN launch on the PyTorch/CUDA port (mdgan_tpu_torch), the counterpart
# of run-distributed.sh with the same flags from shared-args.sh.
#
# $1 is N, the number of discriminators (reference world_size - 1); trailing
# arguments are passed on to the CLI (e.g. --device cpu).  nproc (default 1)
# ranks share the N discriminators, one rank a card, started by
# torch.distributed.run when above 1:
#   nproc=8 ./run-distributed-torch.sh 8
set -euo pipefail
cd "$(dirname "$0")"
source ./shared-args.sh

num_workers="${1:-8}"
swap_interval="${swap_interval:-5000}"
nproc="${nproc:-1}"
python="${PYTHON:-python}"  # the interpreter

launch=("$python")
if [ "$nproc" -gt 1 ]; then
  launch=("$python" -m torch.distributed.run --standalone --nproc_per_node "$nproc")
fi

exec "${launch[@]}" -m mdgan_tpu_torch.cli.train \
  --mode mdgan \
  --dataset "$dataset" \
  --num_workers "$num_workers" \
  --epochs "$epochs" \
  --local_epochs "$local_epochs" \
  --batch_size "$batch_size" \
  --generator_lr "$generator_lr" \
  --discriminator_lr "$discriminator_lr" \
  --swap_interval "$swap_interval" \
  --log_interval "$log_interval" \
  --iid "$iid" \
  --seed "$seed" \
  --beta_1 "$beta_1" \
  --beta_2 "$beta_2" \
  --chunk_size "$chunk_size" \
  --compute_dtype "$compute_dtype" \
  "${@:2}"
