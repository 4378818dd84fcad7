#!/bin/sh
# CI gate: 2-process multi-host training through the REAL CLI (the port
# of bin/run-ci-multihost.sh). Both processes run on this host: with
# device=cuda both ranks share its card, over gloo (NCCL refuses two ranks
# on one card); with device=cpu over gloo on the CPU. Both processes must
# report identical epoch losses.
set -xe

work="${work:-/tmp/ci_multihost}"
smoke="${smoke:-/root/reference/data/smoke_test}"
alphabet="${alphabet:-/root/reference/data/alphabet.txt}"
port="${port:-29977}"
device="${device:-cuda}"

rm -rf "$work"; mkdir -p "$work"

# two-row CSV (absolute wav paths) so a global batch of 2 splits 1/host
python - "$smoke" "$work" <<'EOF'
import os, sys
smoke, work = sys.argv[1], sys.argv[2]
lines = open(os.path.join(smoke, "ldc93s1.csv")).read().splitlines()
cols = lines[1].split(",")
cols[0] = os.path.join(smoke, cols[0])
row = ",".join(cols)
open(os.path.join(work, "two.csv"), "w").write(
    "\n".join([lines[0], row, row]) + "\n"
)
EOF

export STT_TORCH_DIST_BACKEND=gloo

common="--train_files $work/two.csv --alphabet_config_path $alphabet \
  --checkpoint_dir $work/ckpt --n_hidden 32 --epochs 2 \
  --train_batch_size 2 --dropout_rate 0.0 --learning_rate 0.001 \
  --shuffle_batches false --checkpoint_secs 3600 \
  --coordinator_address 127.0.0.1:$port --num_processes 2"

python -m stt_tpu_torch.train --device "$device" $common --process_id 0 > "$work/p0.log" 2>&1 &
pid0=$!
python -m stt_tpu_torch.train --device "$device" $common --process_id 1 > "$work/p1.log" 2>&1 &
pid1=$!
wait $pid0
wait $pid1

# losses only (wall-clock columns differ per process, of course)
grep "train loss" "$work/p0.log" | sed 's/.*train loss \([0-9.]*\).*/\1/' > "$work/l0"
grep "train loss" "$work/p1.log" | sed 's/.*train loss \([0-9.]*\).*/\1/' > "$work/l1"
test -s "$work/l0"
cmp "$work/l0" "$work/l1"
test -f "$work/ckpt/meta.json"
echo "multi-host CI gate OK"
