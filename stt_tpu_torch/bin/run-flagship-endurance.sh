#!/bin/sh
# Flagship-geometry endurance + accuracy run on the card (the port of
# bin/run-flagship-endurance.sh).
#
# 1. Train the small smoke model (alignment source) unless a checkpoint
#    is already present.
# 2. Synthesize a ~320-utterance corpus with REAL transcript diversity
#    by splicing word clips cut at CTC-aligned boundaries
#    (stt_tpu_torch/bin/make_spliced_corpus.py), then materialize offline
#    augmentations (volume/reverb/resample + overlay with the russian
#    smoke clip as interference) via data_set_tool.
# 3. Train the FLAGSHIP geometry (n_hidden=2048, bf16, the K3/K4
#    recurrence kernels) to convergence; loss curve lands in
#    $work/metrics/train.jsonl via --metrics_files.
# 4. Evaluate WER with the full beam 500 + the smoke data's KenLM scorer
#    on train and dev corpora; gate train WER == 0.
set -xe

work="${work:-/tmp/flagship}"
smoke="${smoke:-/root/reference/data/smoke_test}"
alphabet="${alphabet:-/root/reference/data/alphabet.txt}"
align_ckpt="${align_ckpt:-/tmp/ci_ldc93s1_tpu_fused/ckpt}"
epochs="${epochs:-30}"
device="${device:-cuda}"

mkdir -p "$work"

if [ ! -d "$align_ckpt" ]; then
  # the ci script also honors $work — run it in its OWN work dir so the
  # alignment checkpoint lands where align_ckpt points
  work="$(dirname "$align_ckpt")" sh stt_tpu_torch/bin/run-ci-ldc93s1_fused.sh 200
fi

# v2: "synthetic speakers" via speed perturbation; the DEV factors are
# disjoint from (and more extreme than) the train factors, so dev WER
# measures generalization to unseen-voice acoustics, not just unseen
# word sequences
python stt_tpu_torch/bin/make_spliced_corpus.py --device "$device" \
    --smoke_wav "$smoke/LDC93S1.wav" \
    --out_dir "$work/corpus" --n_train 288 --n_dev 32 \
    --train_speakers "0.97,1.0,1.03" --dev_speakers "0.90,0.94,1.06,1.10" \
    --checkpoint_dir "$align_ckpt" \
    --alphabet_config_path "$alphabet" --n_hidden 128

# overlay interference comes from the russian smoke sample (the only
# other recording in the environment)
python -m stt_tpu_torch.tools.data_set_tool \
    --sources "$work/corpus/train.csv" \
    --target "$work/corpus/train_augmented.sdb" \
    --augment "volume[p=0.5,dbfs=-12:0]" \
    --augment "reverb[p=0.3,delay=30.0~15.0,decay=8.0~4.0]" \
    --augment "resample[p=0.2,rate=12000:16000]" \
    --augment "overlay[p=0.3,source=$smoke/russian_sample_data/ru.csv,snr=15.0~5.0]"

mkdir -p "$work/metrics"
python -m stt_tpu_torch.train --device "$device" \
    --train_files "$work/corpus/train_augmented.sdb,$work/corpus/train.csv" \
    --dev_files "$work/corpus/dev.csv" \
    --alphabet_config_path "$alphabet" \
    --checkpoint_dir "$work/ckpt_flagship" \
    --n_hidden 2048 --epochs "$epochs" --learning_rate 0.0002 \
    --train_batch_size 16 --dev_batch_size 16 \
    --compute_dtype bfloat16 \
    --summary_dir "$work/metrics" \
    | tee "$work/train.log"

python -m stt_tpu_torch.evaluate --device "$device" \
    --test_files "$work/corpus/train.csv" \
    --checkpoint_dir "$work/ckpt_flagship" \
    --alphabet_config_path "$alphabet" \
    --n_hidden 2048 --compute_dtype bfloat16 \
    --scorer_path "$smoke/pruned_lm.scorer" \
    --test_output_file "$work/eval_train.json" \
    | tee "$work/eval_train.log"

python -m stt_tpu_torch.evaluate --device "$device" \
    --test_files "$work/corpus/dev.csv" \
    --checkpoint_dir "$work/ckpt_flagship" \
    --alphabet_config_path "$alphabet" \
    --n_hidden 2048 --compute_dtype bfloat16 \
    --scorer_path "$smoke/pruned_lm.scorer" \
    --test_output_file "$work/eval_dev.json" \
    | tee "$work/eval_dev.log"

grep -o "WER: [0-9.]*" "$work/eval_train.log" | head -1

# -- bytes-output-mode leg on the russian smoke sample ---------------------
# (UTF8Alphabet, 256 classes). f32 compute: batch-1 CTC on one long
# utterance is gradient-noise-bound — bf16 oscillates, f32 converges.
ru="$smoke/russian_sample_data"
mkdir -p "$work/ru"
python -m stt_tpu_torch.train --device "$device" \
    --train_files "$ru/ru.csv" \
    --dev_files "$ru/ru.csv" \
    --bytes_output_mode true \
    --checkpoint_dir "$work/ru/ckpt" \
    --n_hidden 512 --epochs "${ru_epochs:-3000}" --learning_rate 0.0003 \
    --dropout_rate 0.0 \
    --train_batch_size 1 --dev_batch_size 1 \
    --compute_dtype float32 \
    | tee "$work/ru/train.log"

# character-unit bytes scorer built by OUR LM pipeline — the reference's
# bytes-mode vocabulary design (its pruned_lm.bytes.scorer FST admits
# exactly the single-character units a-z'; bytes mode targets spaceless
# scripts, so the trie cannot emit the space byte and scorer decodes
# gate the SPACELESS transcript — refereed against the reference's own
# decoder in tests/test_torch_reference_decoder_oracle.py)
python -c "
txt = 'бедняга ребят на его месте должен был быть я'
chars = [c for c in txt if c != ' ']
open('$work/ru/corpus_chars.txt', 'w').write(
    '\n'.join(' '.join(chars) for _ in range(8)) + '\n')
"
python -m stt_tpu_torch.tools.generate_lm \
    --input_txt "$work/ru/corpus_chars.txt" --output_dir "$work/ru" \
    --top_k 500 --arpa_order 3
python -m stt_tpu_torch.tools.generate_scorer_package \
    --lm "$work/ru/lm.binary" --vocab "$work/ru/vocab-500.txt" \
    --package "$work/ru/ru_bytes.scorer" \
    --default_alpha 0.5 --default_beta 0.5 --force_bytes_output_mode

# gate 1: no-LM beam — exact spaced transcript
python -m stt_tpu_torch.evaluate --device "$device" \
    --test_files "$ru/ru.csv" \
    --checkpoint_dir "$work/ru/ckpt" \
    --bytes_output_mode true \
    --n_hidden 512 --compute_dtype float32 \
    --test_output_file "$work/ru/eval_nolm.json" \
    | tee "$work/ru/eval_nolm.log"

# gate 2: our char-unit bytes scorer — spaceless transcript (CER gate)
python -m stt_tpu_torch.evaluate --device "$device" \
    --test_files "$ru/ru.csv" \
    --checkpoint_dir "$work/ru/ckpt" \
    --bytes_output_mode true \
    --n_hidden 512 --compute_dtype float32 \
    --scorer_path "$work/ru/ru_bytes.scorer" \
    --test_output_file "$work/ru/eval_scorer.json" \
    | tee "$work/ru/eval_scorer.log"

grep -o "WER: [0-9.]*" "$work/ru/eval_nolm.log" | head -1
