#!/bin/sh
# CI gate: checkpoint save + resume continues training from the saved
# step (parity: reference bin/run-ci-ldc93s1_checkpoint.sh; the port of
# bin/run-ci-ldc93s1_checkpoint.sh).
set -xe

work="${work:-/tmp/ci_ldc93s1_ckpt}"
smoke="${smoke:-/root/reference/data/smoke_test}"
alphabet="${alphabet:-/root/reference/data/alphabet.txt}"
device="${device:-cuda}"

rm -rf "$work"; mkdir -p "$work"

common="--train_files $smoke/ldc93s1.csv --dev_files $smoke/ldc93s1.csv \
  --alphabet_config_path $alphabet --checkpoint_dir $work/ckpt \
  --n_hidden 100 --train_batch_size 1 --dev_batch_size 1 \
  --learning_rate 0.003 --dropout_rate 0.0"

python -m stt_tpu_torch.train --device "$device" $common --epochs 20
[ -f "$work/ckpt/meta.json" ] || { echo "NO CHECKPOINT WRITTEN"; exit 1; }
[ -f "$work/ckpt/alphabet.txt" ] || { echo "NO ALPHABET SAVED"; exit 1; }
[ -f "$work/ckpt/config.json" ] || { echo "NO FLAGS SAVED"; exit 1; }

# resume: step counter must continue past the first run
python -m stt_tpu_torch.train --device "$device" $common --epochs 5 | tee "$work/resume.log"
echo "run-ci-ldc93s1_checkpoint OK"
