#!/bin/sh
# CI gate: fresh train + dev + test + export with scorer decode, asserting
# the exact smoke transcript (parity: reference bin/run-ci-ldc93s1_new.sh
# + ci_scripts/asserts.sh:189-199; the port of bin/run-ci-ldc93s1_new.sh).
set -xe

epochs="${1:-150}"
work="${work:-/tmp/ci_ldc93s1_new}"
smoke="${smoke:-/root/reference/data/smoke_test}"
alphabet="${alphabet:-/root/reference/data/alphabet.txt}"
device="${device:-cuda}"
expected="she had your dark suit in greasy wash water all year"

rm -rf "$work"; mkdir -p "$work"

python -m stt_tpu_torch.train --device "$device" \
    --train_files "$smoke/ldc93s1.csv" \
    --dev_files "$smoke/ldc93s1.csv" \
    --alphabet_config_path "$alphabet" \
    --checkpoint_dir "$work/ckpt" \
    --n_hidden 100 --epochs "$epochs" --learning_rate 0.003 \
    --train_batch_size 1 --dev_batch_size 1 --dropout_rate 0.0

python -m stt_tpu_torch.evaluate --device "$device" \
    --test_files "$smoke/ldc93s1.csv" \
    --alphabet_config_path "$alphabet" \
    --checkpoint_dir "$work/ckpt" --n_hidden 100 \
    --export_beam_width 64 \
    --scorer_path "$smoke/pruned_lm.scorer" \
    --test_output_file "$work/test_output.json"

python -m stt_tpu_torch.export --device "$device" \
    --checkpoint_dir "$work/ckpt" --export_dir "$work/model" \
    --alphabet_config_path "$alphabet" --n_hidden 100

out=$(python -m stt_tpu_torch.client --device "$device" --model "$work/model" \
      --audio "$smoke/LDC93S1.wav" --beam_width 64 \
      --scorer "$smoke/pruned_lm.scorer")
echo "decoded: $out"
[ "$out" = "$expected" ] || { echo "TRANSCRIPT MISMATCH"; exit 1; }
echo "run-ci-ldc93s1_new OK"
