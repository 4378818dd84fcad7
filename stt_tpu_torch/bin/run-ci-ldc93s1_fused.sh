#!/bin/sh
# CI gate (card variant): train with the LSTM training kernels engaged
# (batch 8, bf16, n_hidden 128; K3 and K4, stt_tpu_torch/ops/csrc/
# lstm_train.cu, take every batch on the card), then assert the exact
# smoke transcript at test time. The port of
# bin/run-ci-ldc93s1_tpu_fused.sh; with device=cpu the kernels' plain
# versions run and the gate still holds.
set -xe

epochs="${1:-200}"
work="${work:-/tmp/ci_ldc93s1_tpu_fused}"
smoke="${smoke:-/root/reference/data/smoke_test}"
alphabet="${alphabet:-/root/reference/data/alphabet.txt}"
device="${device:-cuda}"
expected="she had your dark suit in greasy wash water all year"

rm -rf "$work"; mkdir -p "$work"

# batch 8 of the same utterance
{
  echo "wav_filename,wav_filesize,transcript"
  for i in 1 2 3 4 5 6 7 8; do
    echo "$smoke/LDC93S1.wav,93638,$expected"
  done
} > "$work/ldc93s1_x8.csv"

python -m stt_tpu_torch.train --device "$device" \
    --train_files "$work/ldc93s1_x8.csv" \
    --dev_files "$work/ldc93s1_x8.csv" \
    --alphabet_config_path "$alphabet" \
    --checkpoint_dir "$work/ckpt" \
    --n_hidden 128 --epochs "$epochs" --learning_rate 0.002 \
    --train_batch_size 8 --compute_dtype bfloat16

python -m stt_tpu_torch.evaluate --device "$device" \
    --test_files "$smoke/ldc93s1.csv" \
    --checkpoint_dir "$work/ckpt" \
    --alphabet_config_path "$alphabet" \
    --n_hidden 128 \
    --test_output_file "$work/test_output.json"

python - "$work/test_output.json" "$expected" <<'EOF'
import json, sys
samples = json.load(open(sys.argv[1]))
res = samples[0]["res"]
assert res == sys.argv[2], f"transcript mismatch: {res!r}"
print("fused-train smoke transcript OK")
EOF
