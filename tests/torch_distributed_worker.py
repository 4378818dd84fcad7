"""One rank of a two-process data-parallel run of stt_tpu_torch on the CPU
(gloo), for tests/test_torch_distributed.py, which starts one process a
rank and reads what they print:

    python tests/torch_distributed_worker.py RANK WORLD PORT WORKDIR

WORKDIR holds inputs.npz (the global batch and the parameters, as numpy)
and dataset.json (a train and a dev CSV, an alphabet). The rank joins the
group over localhost:PORT, then prints one JSON line each for:
  "step": three train steps on its rows of the global batch, re-padded to
          the global lengths (loss, grad_norm, per-example losses);
  "params": where its parameters ended (saved to WORKDIR/rank<R>.npz);
  "wer": the WER merge of rank-specific counters;
  "train": the step losses of `train(config)` with --num_processes 2;
  "eval": the sample ids of its share of `evaluate(config)`.
"""

import json
import os
import sys

rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ["CUDA_VISIBLE_DEVICES"] = ""
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stt_tpu_torch.artifact import params_from_numpy  # noqa: E402
from stt_tpu_torch.config import SttConfig, maybe_initialize_distributed  # noqa: E402
from stt_tpu_torch.evaluate import evaluate  # noqa: E402
from stt_tpu_torch.models import ModelConfig  # noqa: E402
from stt_tpu_torch.parallel import distributed  # noqa: E402
from stt_tpu_torch.train import trainer  # noqa: E402
from stt_tpu_torch.train.step import Batch, create_train_state, make_train_step  # noqa: E402


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, "rank": rank, **fields}), flush=True)


with open(os.path.join(workdir, "dataset.json")) as f:
    dataset = json.load(f)
config = SttConfig(
    train_files=[dataset["train"]], dev_files=[dataset["dev"]], test_files=[dataset["dev"]],
    alphabet_config_path=dataset["alphabet"], n_hidden=32, train_batch_size=4,
    dev_batch_size=1, test_batch_size=1, epochs=2, dropout_rate=0.0, learning_rate=0.003,
    seed=1, export_beam_width=8, num_processes=world, process_id=rank,
    coordinator_address=f"localhost:{port}", save_checkpoint_dir=os.path.join(workdir, "ckpt"),
    summary_dir=os.path.join(workdir, "summary"), input_workers=0, prefetch_batches=0,
)
maybe_initialize_distributed(config, device="cpu")
assert (distributed.process_index(), distributed.process_count()) == (rank, world)

# ---- three steps on this rank's rows of one global batch ------------------
inputs = np.load(os.path.join(workdir, "inputs.npz"))
feats, feat_lens, labels, label_lens = (inputs[k] for k in ("feats", "feat_lens", "labels",
                                                            "label_lens"))
params = {}
for key in inputs.files:
    if key.startswith("param:"):
        layer, leaf = key[len("param:"):].split("/")
        params.setdefault(layer, {})[leaf] = inputs[key]
geometry = json.loads(str(inputs["geometry"]))
cfg = ModelConfig(**geometry, dropout_rates=(0.0,) * 6)
state = create_train_state(cfg, device="cpu", model=params_from_numpy(params, cfg),
                           learning_rate=float(inputs["lr"]))
start, end = distributed.host_batch_bounds(feats.shape[0])
# this rank's rows, cut to their own longest utterance and label
t_local, l_local = int(feat_lens[start:end].max()), int(label_lens[start:end].max())
local = Batch(torch.from_numpy(feats[start:end, :t_local]),
              torch.from_numpy(feat_lens[start:end]),
              torch.from_numpy(labels[start:end, :l_local]),
              torch.from_numpy(label_lens[start:end]))
padded_feats, padded_labels = distributed.agree_global_padding(local.features, local.labels)
local = local._replace(features=padded_feats, labels=padded_labels)
step = make_train_step()
for i in range(3):
    state, m = step(state, local, 9)
    emit("step", step=i, loss=m.loss.item(), grad_norm=m.grad_norm.item(),
         per_example=m.per_example_loss.tolist(), shapes=[list(local.features.shape),
                                                          list(local.labels.shape)])
np.savez(os.path.join(workdir, f"rank{rank}.npz"),
         **{k: v.detach().numpy() for k, v in state.model.named_parameters()})
emit("params", rows=[start, end])

# ---- the WER merge -------------------------------------------------------
counters = [(5, 100, 20, 500), (3, 50, 10, 250)][rank]
emit("wer", merged=list(distributed.merge_wer_counters(*counters)))

# ---- the trainer and evaluate over two processes --------------------------
made = trainer.make_train_step


def recording_step():
    inner = made()

    def train_step(state, batch, seed=0):
        state, metrics = inner(state, batch, seed)
        emit("train", step=state.step, loss=metrics.loss.item(), rows=int(batch.features.shape[0]))
        return state, metrics

    return train_step


trainer.make_train_step = recording_step
state = trainer.train(config, device="cpu")
reports = evaluate(config, model=state.model, device="cpu")
emit("eval", ids=[r.sample_id for r in reports[0]], wer=[r.wer for r in reports[0]])
