#!/bin/sh
# CI gate: train from FLAC and Ogg Vorbis sources through the in-tree
# decoders (parity: reference run-ci flac/vorbis variants; the port of
# bin/run-ci-ldc93s1_audio_formats.sh).
set -xe

work="${work:-/tmp/ci_ldc93s1_formats}"
smoke="${smoke:-/root/reference/data/smoke_test}"
alphabet="${alphabet:-/root/reference/data/alphabet.txt}"
device="${device:-cuda}"

rm -rf "$work"; mkdir -p "$work"

for variant in flac vorbis; do
    python -m stt_tpu_torch.train --device "$device" \
        --train_files "$smoke/ldc93s1_${variant}.csv" \
        --alphabet_config_path "$alphabet" \
        --checkpoint_dir "$work/ckpt_${variant}" \
        --n_hidden 64 --epochs 10 --learning_rate 0.003 \
        --train_batch_size 1 --dropout_rate 0.0
done
echo "run-ci-ldc93s1_audio_formats OK"
