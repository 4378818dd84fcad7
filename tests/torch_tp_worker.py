"""One rank of a tensor-parallel run of stt_tpu_torch on the CPU (gloo),
for tests/test_torch_tp.py, which starts one process a rank and reads what
they print:

    python tests/torch_tp_worker.py RANK WORLD PORT WORKDIR N_MODEL

WORKDIR holds inputs.npz: the parameters, as numpy, the geometry, and the
global batches of the cases to step ("case:NAME:feats", ...). The rank
joins the group over localhost:PORT, lays the ranks out on a (WORLD /
N_MODEL, N_MODEL) mesh and, for each case, steps three times with
`make_train_step_tp` on its data index's rows from the same parameters,
printing one JSON line a step ("step": loss, grad_norm, per-example
losses), and saves to WORKDIR/NAME.rank<R>.npz the gathered gradients of
the first step ("grad:<name>") and the gathered parameters after the
third ("param:<name>"); with "replicate_uneven" true in inputs.npz, the
step takes widths that do not divide over the model ranks. With
dataset.json in WORKDIR it then runs `train(config)` with
--n_model_parallel (the "train" lines: each step's loss): its "epochs" from
scratch into WORKDIR/ckpt, then, with "resume", one epoch resumed from that
checkpoint into WORKDIR/resumed.
"""

import json
import os
import sys

rank, world, port, workdir, n_model = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                       sys.argv[4], int(sys.argv[5]))
os.environ["CUDA_VISIBLE_DEVICES"] = ""
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stt_tpu_torch.artifact import params_from_numpy  # noqa: E402
from stt_tpu_torch.config import SttConfig  # noqa: E402
from stt_tpu_torch.models import ModelConfig  # noqa: E402
from stt_tpu_torch.models.deepspeech import param_shapes  # noqa: E402
from stt_tpu_torch.parallel import distributed, gather_params, make_mesh  # noqa: E402
from stt_tpu_torch.train import trainer  # noqa: E402
from stt_tpu_torch.train.step import (  # noqa: E402
    Batch,
    create_train_state,
    make_train_step_tp,
    shard_train_state,
)

torch.set_num_threads(1)


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, "rank": rank, **fields}), flush=True)


distributed.initialize(f"localhost:{port}", world, rank, backend="gloo", device="cpu")
mesh = make_mesh(n_model=n_model)
emit("mesh", data_index=mesh.data_index, model_index=mesh.model_index, n_data=mesh.n_data)

inputs = np.load(os.path.join(workdir, "inputs.npz"))
params = {}
for key in inputs.files:
    if key.startswith("param:"):
        layer, leaf = key[len("param:"):].split("/")
        params.setdefault(layer, {})[leaf] = inputs[key]
geometry = json.loads(str(inputs["geometry"]))
cases = sorted({key.split(":")[1] for key in inputs.files if key.startswith("case:")})
for case in cases:
    arrays = [inputs[f"case:{case}:{k}"] for k in ("feats", "feat_lens", "labels", "label_lens")]
    rate = float(inputs[f"case:{case}:dropout"])
    cfg = ModelConfig(**geometry, dropout_rates=(rate, rate, rate, 0.0, 0.0, rate))
    full = create_train_state(cfg, device="cpu", model=params_from_numpy(params, cfg),
                              learning_rate=float(inputs["lr"]))
    state = shard_train_state(full, mesh)
    start, end = mesh.rows(arrays[0].shape[0])
    batch = Batch(*(torch.from_numpy(a[start:end]) for a in arrays))
    step = make_train_step_tp(cfg, mesh, replicate_uneven=bool(inputs["replicate_uneven"]))
    saved = {}
    for i in range(3):
        state, m = step(state, batch, 9)
        emit("step", case=case, step=i, loss=m.loss.item(), grad_norm=m.grad_norm.item(),
             per_example=m.per_example_loss.tolist(), rows=[start, end])
        if i == 0:
            grads = gather_params({k: v.grad for k, v in state.model.named_parameters()}, mesh,
                                  param_shapes(cfg))
            saved.update({f"grad:{k}": v.numpy() for k, v in grads.items()})
    final = gather_params({k: v.detach() for k, v in state.params.items()}, mesh,
                          param_shapes(cfg))
    saved.update({f"param:{k}": v.numpy() for k, v in final.items()})
    np.savez(os.path.join(workdir, f"{case}.rank{rank}.npz"), **saved)

dataset_path = os.path.join(workdir, "dataset.json")
if os.path.exists(dataset_path):
    with open(dataset_path) as f:
        dataset = json.load(f)
    made = trainer.make_train_step_tp

    def recording_step(*args, **kw):
        inner = made(*args, **kw)

        def train_step(state, batch, seed=0):
            state, metrics = inner(state, batch, seed)
            emit("train", step=state.step, loss=metrics.loss.item(),
                 rows=int(batch.features.shape[0]))
            return state, metrics

        return train_step

    trainer.make_train_step_tp = recording_step
    common = dict(
        train_files=[dataset["train"]], dev_files=[dataset["dev"]],
        alphabet_config_path=dataset["alphabet"], n_hidden=dataset["n_hidden"],
        train_batch_size=4, dev_batch_size=1, dropout_rate=0.0, learning_rate=0.003, seed=1,
        num_processes=world, process_id=rank, coordinator_address=f"localhost:{port}",
        n_model_parallel=n_model, input_workers=0, prefetch_batches=0)
    trainer.train(SttConfig(epochs=dataset["epochs"],
                            save_checkpoint_dir=os.path.join(workdir, "ckpt"),
                            summary_dir=os.path.join(workdir, "summary"), **common),
                  device="cpu")
    emit("trained")
    if dataset["resume"]:
        trainer.train(SttConfig(epochs=1, load_checkpoint_dir=os.path.join(workdir, "ckpt"),
                                save_checkpoint_dir=os.path.join(workdir, "resumed"), **common),
                      device="cpu")
        emit("resumed")
