#!/bin/sh
# Smoke training run: overfit the single LDC93S1 utterance and verify the
# pipeline end to end (parity: reference bin/run-ldc93s1.sh; the port of
# bin/run-ldc93s1.sh).
set -xe

ldc93s1_dir="${ldc93s1_dir:-./data/ldc93s1}"
ckpt_dir="${ckpt_dir:-/tmp/ldc93s1_ckpt}"
export_dir="${export_dir:-/tmp/ldc93s1_model}"
smoke_src="${smoke_src:-/root/reference/data/smoke_test}"
alphabet="${alphabet:-/root/reference/data/alphabet.txt}"
device="${device:-cuda}"

if [ ! -f "$ldc93s1_dir/ldc93s1.csv" ]; then
    echo "Importing LDC93S1 into $ldc93s1_dir"
    python -m stt_tpu_torch.tools.import_ldc93s1 "$ldc93s1_dir" --source_dir "$smoke_src"
fi

python -m stt_tpu_torch.train --device "$device" \
    --train_files "$ldc93s1_dir/ldc93s1.csv" \
    --dev_files "$ldc93s1_dir/ldc93s1.csv" \
    --alphabet_config_path "$alphabet" \
    --checkpoint_dir "$ckpt_dir" \
    --n_hidden 100 --epochs 200 --learning_rate 0.003 \
    --train_batch_size 1 --dev_batch_size 1 --dropout_rate 0.0

python -m stt_tpu_torch.evaluate --device "$device" \
    --test_files "$ldc93s1_dir/ldc93s1.csv" \
    --alphabet_config_path "$alphabet" \
    --checkpoint_dir "$ckpt_dir" --n_hidden 100 \
    --export_beam_width 64

python -m stt_tpu_torch.export --device "$device" \
    --checkpoint_dir "$ckpt_dir" --export_dir "$export_dir" \
    --alphabet_config_path "$alphabet" --n_hidden 100

python -m stt_tpu_torch.training_graph_inference --device "$device" \
    --one_shot_infer "$ldc93s1_dir/LDC93S1.wav" \
    --alphabet_config_path "$alphabet" \
    --checkpoint_dir "$ckpt_dir" --n_hidden 100 --beam_width 64
