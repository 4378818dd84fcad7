"""Data parallelism across processes (`stt_tpu_torch.parallel`) on the CPU:
the one-process functions against stt_tpu's, and a two-process gloo run
(tests/torch_distributed_worker.py, one process a rank, each with its own
timeout) of the train step, the WER merge, the trainer and evaluate.

Tolerances: the ranks' losses and parameters are equal bit for bit (each
rank's loss is the all-reduced sum over the global count, and every rank
applies the same all-reduced gradients). Against the one-process step on
the whole batch: the loss within 1e-6 relative on the first step (the same
float32 terms, summed in two halves; measured 9.0e-8) and 1e-5 on the next
two (the parameters drift by the gradients' rounding; measured 0), the
gradient norm within 1e-5 (measured 3.3e-7). Against stt_tpu's
one-process `make_train_step` on the same global batch and parameters, the
tolerances of tests/test_torch_train_step.py: 1e-5 on the first step, 1e-4
on the next two (measured 0, 1.3e-6, 6.7e-6). The trainer's losses against
the same run in one process: 1e-5 (measured 7.8e-8); the merged dev loss
1e-6 (measured 0).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import init_params
from stt_tpu.parallel import distributed as jax_distributed
from stt_tpu.train import Batch as JaxBatch
from stt_tpu.train import create_train_state as jax_create_train_state
from stt_tpu.train import make_train_step as jax_make_train_step
from stt_tpu.train.step import create_optimizer as jax_create_optimizer
from stt_tpu_torch.artifact import params_from_numpy
from stt_tpu_torch.config import SttConfig, maybe_initialize_distributed
from stt_tpu_torch.models import ModelConfig
from stt_tpu_torch.parallel import Mesh, distributed, make_mesh
from stt_tpu_torch.train import Batch, create_train_state, make_train_step
from test_torch_trainer import write_csv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_distributed_worker.py")
GEOMETRY = dict(n_input=26, n_context=9, n_hidden=48, n_cell_dim=64, n_out=29)
LR = 1e-3
RANK_TIMEOUT_S = 120


def test_one_process_functions_equal_stt_tpus():
    assert distributed.initialize() == jax_distributed.initialize() == (0, 1)
    assert distributed.host_batch_bounds(64) == jax_distributed.host_batch_bounds(64) == (0, 64)
    v = np.asarray([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(distributed.allreduce_sum_across_hosts(v), v)
    assert distributed.merge_wer_counters(5, 100, 20, 500) == \
        jax_distributed.merge_wer_counters(5, 100, 20, 500) == (0.05, 0.04)
    feats, labels = torch.zeros(2, 7, 3), torch.zeros(2, 4, dtype=torch.int32)
    assert distributed.agree_global_padding(feats, labels) == (feats, labels)
    t = torch.ones(3)
    assert distributed.allreduce_(t) is t and t.tolist() == [1.0, 1.0, 1.0]
    distributed.barrier()
    maybe_initialize_distributed(SttConfig(num_processes=1), device="cpu")
    assert not torch.distributed.is_initialized()


def test_data_mesh_and_local_device():
    mesh = make_mesh()
    assert (mesh.n_data, mesh.rank) == (1, 0) and mesh.rows(16) == (0, 16)
    assert make_mesh(n_data=1).rows(3) == (0, 3)
    # rank r is (r // n_model, r % n_model), stt_tpu's reshape(n_data,
    # n_model) order; a data index's model ranks feed the same rows
    grid = [Mesh(2, 3, r) for r in range(6)]
    assert [(m.data_index, m.model_index) for m in grid] == \
        [(d, m) for d in range(2) for m in range(3)]
    assert [m.rows(8) for m in grid] == [(0, 4)] * 3 + [(4, 8)] * 3
    assert np.asarray(range(6)).reshape(2, 3)[1, 2] == 5 == grid[5].rank
    with pytest.raises(ValueError, match="divisible by --n_model_parallel 2"):
        make_mesh(n_model=2)  # one process holds no model axis of two ranks
    with pytest.raises(ValueError, match="data axis"):
        make_mesh(n_data=2)
    assert distributed.local_device("cpu") == torch.device("cpu")
    assert distributed.local_device("cuda:1") == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize(num_processes=2, device="cpu")


def global_batch(seed=1, B=4, T=40, L=8):
    """Rows of different lengths, so that each rank's own longest utterance
    and label differ from the global batch's (agree_global_padding re-pads)."""
    rs = np.random.RandomState(seed)
    feats = (rs.randn(B, T, GEOMETRY["n_input"]) * 3).astype(np.float32)
    feat_lens = np.array([T, 33, 27, 21], np.int32)
    labels = rs.randint(0, GEOMETRY["n_out"] - 1, size=(B, L)).astype(np.int32)
    label_lens = np.array([8, 6, 4, 5], np.int32)
    for i, n in enumerate(feat_lens):
        feats[i, n:] = 0.0
    for i, n in enumerate(label_lens):
        labels[i, n:] = 0
    return feats, feat_lens, labels, label_lens


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(workdir, world=2):
    """One worker process a rank, all started together, each killed after
    RANK_TIMEOUT_S; returns the JSON lines each printed."""
    port = str(free_port())
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), port, str(workdir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    lines = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=RANK_TIMEOUT_S)
            assert proc.returncode == 0, stderr[-4000:]
            lines.append([json.loads(line) for line in stdout.splitlines() if line.startswith("{")])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return lines


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dp")
    rs = np.random.RandomState(0)
    alphabet = workdir / "alphabet.txt"
    alphabet.write_text("".join(label + "\n" for label in " abcdefgh"))
    data = {"train": write_csv(workdir / "train.csv", rs, 8),
            "dev": write_csv(workdir / "dev.csv", rs, 3), "alphabet": str(alphabet)}
    (workdir / "dataset.json").write_text(json.dumps(data))
    jax_cfg = JaxModelConfig(**GEOMETRY, dropout_rates=(0.0,) * 6)
    params = jax.device_get(init_params(jax.random.PRNGKey(0), jax_cfg))
    arrays = global_batch()
    np.savez(workdir / "inputs.npz", feats=arrays[0], feat_lens=arrays[1], labels=arrays[2],
             label_lens=arrays[3], lr=LR, geometry=json.dumps(GEOMETRY),
             **{f"param:{layer}/{leaf}": np.asarray(v)
                for layer, d in params.items() for leaf, v in d.items()})
    lines = run_ranks(workdir)
    return {"workdir": workdir, "lines": lines, "params": params, "arrays": arrays,
            "data": data, "jax_cfg": jax_cfg}


def of(lines, kind):
    return [line for line in lines if line["kind"] == kind]


def test_two_ranks_step_as_one_process_and_stt_tpu_on_the_global_batch(two_ranks):
    lines, params, arrays = two_ranks["lines"], two_ranks["params"], two_ranks["arrays"]
    steps = [of(rank_lines, "step") for rank_lines in lines]
    # each rank fed its own rows, re-padded to the global batch's lengths
    assert [s[0]["shapes"] for s in steps] == [[[2, 40, 26], [2, 8]]] * 2
    for a, b in zip(*steps):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    # the ranks' parameters are equal, bit for bit
    r0, r1 = (np.load(two_ranks["workdir"] / f"rank{r}.npz") for r in range(2))
    for key in r0.files:
        np.testing.assert_array_equal(r0[key], r1[key])

    # the one-process port step and stt_tpu's make_train_step on the whole batch
    cfg = ModelConfig(**GEOMETRY, dropout_rates=(0.0,) * 6)
    state = create_train_state(cfg, device="cpu", model=params_from_numpy(params, cfg),
                               learning_rate=LR)
    step = make_train_step()
    optimizer = jax_create_optimizer(learning_rate=LR)
    jstate = jax_create_train_state(None, two_ranks["jax_cfg"], optimizer, params=params)
    jstep = jax_make_train_step(two_ranks["jax_cfg"], optimizer)
    for i in range(3):
        state, m = step(state, Batch(*map(torch.from_numpy, arrays)), 9)
        jstate, jm = jstep(jstate, JaxBatch(*map(jnp.asarray, arrays)), jax.random.PRNGKey(9))
        got = steps[0][i]
        np.testing.assert_allclose(got["loss"], m.loss.item(), rtol=1e-6 if i == 0 else 1e-5)
        np.testing.assert_allclose(got["loss"], float(jm.loss), rtol=1e-5 if i == 0 else 1e-4)
        np.testing.assert_allclose(got["grad_norm"], m.grad_norm.item(), rtol=1e-5)
        both = steps[0][i]["per_example"] + steps[1][i]["per_example"]
        np.testing.assert_allclose(both, m.per_example_loss.numpy(), rtol=1e-5)


def test_two_ranks_merge_wer_counters(two_ranks):
    merged = [of(rank_lines, "wer")[0]["merged"] for rank_lines in two_ranks["lines"]]
    assert merged[0] == merged[1]
    assert merged[0] == pytest.approx([8 / 150, 30 / 750], rel=1e-12)


def test_two_process_trainer_and_evaluate_equal_one_process(two_ranks, tmp_path):
    """train(config) with --num_processes 2: both ranks step on 2 of the 4
    rows with the same losses, equal to one process on all 4; rank 0 alone
    writes the checkpoints and the scalars; dev losses merge; evaluate
    shares the test batches round-robin."""
    from stt_tpu_torch.evaluate import evaluate
    from stt_tpu_torch.train import trainer

    lines, data = two_ranks["lines"], two_ranks["data"]
    train_steps = [of(rank_lines, "train") for rank_lines in lines]
    assert len(train_steps[0]) == len(train_steps[1]) == 1 + 2 * 2  # dummy run, 2 epochs x 2
    for a, b in zip(*train_steps):
        assert a["loss"] == b["loss"] and a["rows"] == b["rows"] == 2

    recorded = []
    made = trainer.make_train_step

    def recording_step():
        inner = made()

        def train_step(state, batch, seed=0):
            state, metrics = inner(state, batch, seed)
            recorded.append(metrics.loss.item())
            return state, metrics
        return train_step

    config = SttConfig(
        train_files=[data["train"]], dev_files=[data["dev"]], test_files=[data["dev"]],
        alphabet_config_path=data["alphabet"], n_hidden=32, train_batch_size=4, dev_batch_size=1,
        test_batch_size=1, epochs=2, dropout_rate=0.0, learning_rate=0.003, seed=1,
        export_beam_width=8, summary_dir=str(tmp_path / "summary"), input_workers=0,
        prefetch_batches=0)
    trainer.make_train_step = recording_step
    try:
        state = trainer.train(config, device="cpu")
    finally:
        trainer.make_train_step = made
    np.testing.assert_allclose([s["loss"] for s in train_steps[0]], recorded, rtol=1e-5)

    workdir = two_ranks["workdir"]
    assert (workdir / "ckpt").is_dir()
    scalars = [json.loads(line) for line in
               (workdir / "summary" / "scalars.jsonl").read_text().splitlines()]
    one = [json.loads(line) for line in (tmp_path / "summary" / "scalars.jsonl").read_text()
           .splitlines()]
    dev = [s["dev/loss"] for s in scalars if "dev/loss" in s]
    want = [s["dev/loss"] for s in one if "dev/loss" in s]
    assert len(dev) == len(want) == 2
    np.testing.assert_allclose(dev, want, rtol=1e-6)
    # one writer: rank 0's scalars hold each step once
    assert len([s for s in scalars if "train/step_loss" in s]) == 4

    evals = [of(rank_lines, "eval")[0] for rank_lines in lines]
    ids = [e["ids"] for e in evals]
    assert len(ids[0]) == 2 and len(ids[1]) == 1 and not set(ids[0]) & set(ids[1])
    report = evaluate(config, model=state.model, device="cpu")[0]
    assert sorted(ids[0] + ids[1]) == sorted(r.sample_id for r in report)
