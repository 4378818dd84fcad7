"""Tensor parallelism (`stt_tpu_torch.parallel.tp`, `mesh`, and
`train.step.make_train_step_tp`) on the CPU: the shard rule and the
refusal against stt_tpu's in one process, then real ranks over gloo
(tests/torch_tp_worker.py, one process a rank, each with its own timeout)
on (1 x 2) and (2 x 2) meshes, and a (1 x 3) mesh over widths that do not
all divide by 3.

Geometry n_input 8, n_context 2, n_hidden 64, n_cell_dim 128, n_out 29
(layer_6 stays whole: 29 does not divide), T 10, three steps at lr 1e-3.
B 16 on (1 x 2) and 32 on (2 x 2), so each model rank's recurrence takes 8
rows. The reference is stt_tpu's `make_train_step_tp` on the same mesh of
the 8 CPU devices with STT_TPU_TP_FUSED=1, so that it runs its Pallas
recurrence in interpret mode, whose numerics the port's plain K3/K4
follow.

Tolerances (measured values: the largest over both meshes and all steps):
- against stt_tpu's TP step, those to which stt_tpu holds its own two TP
  programs (tests/test_sharding.py): the loss and the per-example losses
  2e-5 relative (measured 1.0e-6, 1.7e-6), the gradient norm 1e-4 (3.2e-6),
  the parameters after three steps 2e-3 (5.6e-5 absolute);
- against the port's one-process step on the global batch: the loss 1e-5
  relative on the first step (measured 0: equal), the per-example losses
  and gradient norms of all three 1e-5 (1.1e-7 for the norm), the first
  step's gradients leaf by leaf 1e-5 relative with 1e-7 absolute (4.8e-7
  absolute at most), the parameters after three steps 1e-4 absolute (5.6e-5:
  Adam moves a parameter whose gradient is near 0 by up to lr whatever the
  gradient's size, so the gradients' rounding shows there);
- the replicated-recurrence branch (3 rows a data index, K = 2): against
  the port's one-process step as above (loss 9.4e-8, gradients 4.8e-7), and
  against stt_tpu's TP step without STT_TPU_TP_FUSED (its lax.scan twin,
  in f32, where the port's recurrence differentiates through K3/K4's bf16
  stash of the pre-activations) at 2e-5 on the loss (2.8e-6), 1e-3 on the
  gradient norm (1.7e-5), and the parameters' updates over three steps
  to 2e-2 of their norm (5.3e-3; the largest difference, 2.0e-3, is near
  the 6e-3 that three Adam steps at lr 1e-3 can move any two runs apart);
- dropout 0.3: the model ranks of one data index give bit-equal
  per-example losses (their masks come from the same (seed, step, data
  index) generator);
- the trainer at --num_processes 2 --n_model_parallel 2 against one
  process: the first loss 1e-5 (measured 0), the later ones 1e-5 (7.0e-7),
  the merged dev loss 1e-6 (3.3e-7: the dev pass runs the gathered model,
  whose parameters carry the TP steps' rounding); its checkpoint resumed by
  one process and by the TP run: 1e-5 (7.4e-8);
- the uneven layout on (1 x 3), n_hidden 66 and n_cell_dim 64 (layer_3 and
  the LSTM replicated), as the trainer steps it: against the port's
  one-process step as in the main case (loss 0, per-example losses 1.2e-7,
  gradient norms 1.1e-7, gradients 2.4e-7 absolute, parameters 1.7e-6
  absolute), against stt_tpu's trainer step (GSPMD over param_sharding,
  its lax.scan) the losses 2e-5 (3.4e-6), the first gradient norm 1e-4
  (6.7e-6) and the updates 2e-2 of their norm (1.4e-2, as in the
  replicated-recurrence branch's case); the trainer at --num_processes 3
  --n_model_parallel 3 and n_hidden 64 (every layer replicated) against
  one process: the losses 1e-5 (measured 0), the dev loss 1e-6 (1.7e-8).
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
from stt_tpu.parallel import batch_sharding, make_mesh as jax_make_mesh, param_sharding, replicated
from stt_tpu.parallel.mesh import model_partition_spec as jax_model_partition_spec
from stt_tpu.train import Batch as JaxBatch
from stt_tpu.train import create_train_state as jax_create_train_state
from stt_tpu.train import make_train_step_tp as jax_make_train_step_tp
from stt_tpu.train.step import create_optimizer as jax_create_optimizer
from stt_tpu_torch.artifact import params_from_numpy
from stt_tpu_torch.config import SttConfig
from stt_tpu_torch.models import ModelConfig
from stt_tpu_torch.models.deepspeech import param_shapes
from stt_tpu_torch.parallel.mesh import Mesh, join_shards, model_partition_spec, shard_params
from stt_tpu_torch.train import Batch, create_train_state, make_train_step
from stt_tpu_torch.train.step import make_train_step_tp
from test_torch_trainer import write_csv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_worker.py")
GEOMETRY = dict(n_input=8, n_context=2, n_hidden=64, n_cell_dim=128, n_out=29)
LR = 1e-3
T = 10
RANK_TIMEOUT_S = 150
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x3": (1, 3)}
# widths that do not all divide over 3 model ranks: layers 1, 2 and 5 (66)
# shard, layer_3 (64) and the LSTM (4H = 256) stay whole
UNEVEN_GEOMETRY = dict(GEOMETRY, n_hidden=66, n_cell_dim=64)


def flat(params) -> dict:
    return {f"{layer}/{leaf}": np.asarray(v) for layer, d in params.items() for leaf, v in d.items()}


# ---- one process -----------------------------------------------------------


@pytest.mark.parametrize("n_model", [2, 4])
def test_shard_rule_equals_stt_tpus(n_model):
    """On every leaf of the parameters and of Adam's state (with layer
    norms, whose vectors shard), the port's spec is stt_tpu's."""
    cfg = JaxModelConfig(**GEOMETRY, layer_norm=True)
    optimizer = jax_create_optimizer()
    state = jax_create_train_state(jax.random.PRNGKey(0), cfg, optimizer)
    leaves = jax.tree.leaves(state.params) + jax.tree.leaves(state.opt_state)
    assert len(leaves) > 40
    for leaf in leaves:
        assert model_partition_spec(leaf.shape, n_model) == \
            tuple(jax_model_partition_spec(leaf, n_model)), leaf.shape
    assert model_partition_spec((64, 29), n_model) == ()  # n_out stays whole
    assert model_partition_spec((1,), n_model) == ()


@pytest.mark.parametrize("n_model", [2, 4])
def test_shard_params_then_join_is_the_identity(n_model):
    cfg = ModelConfig(**GEOMETRY, layer_norm=True)
    rs = np.random.RandomState(0)
    full = {k: torch.from_numpy(rs.randn(*s).astype(np.float32))
            for k, s in param_shapes(cfg).items()}
    shards = [shard_params(full, Mesh(1, n_model, m)) for m in range(n_model)]
    assert shards[1]["lstm/kernel"].shape == (256, 512 // n_model)
    assert shards[1]["layer_6/w"] is full["layer_6/w"]
    for name, value in full.items():
        joined = join_shards([s[name] for s in shards], value.shape)
        assert torch.equal(joined, value), name
    # rank m holds columns [m 4H/K, (m+1) 4H/K) of the gate kernel
    np.testing.assert_array_equal(shards[1]["lstm/kernel"],
                                  full["lstm/kernel"][:, 512 // n_model:2 * 512 // n_model])


@pytest.mark.parametrize("n_hidden,n_model", [(30, 4), (96, 4)])
def test_refusal_matches_stt_tpus(n_hidden, n_model):
    """A hidden width that does not divide over the model axis is refused,
    in stt_tpu's words; n_out 29 alone does not refuse."""
    geometry = dict(GEOMETRY, n_hidden=n_hidden, n_cell_dim=128)
    mesh = jax_make_mesh(2, n_model)
    optimizer = jax_create_optimizer()
    jstate = jax_create_train_state(jax.random.PRNGKey(0), JaxModelConfig(**geometry), optimizer)
    bind = jax_make_train_step_tp(JaxModelConfig(**geometry), optimizer, mesh)
    port = Mesh(2, n_model, 0)
    if n_hidden % n_model:
        with pytest.raises(ValueError) as want:
            bind(jstate)
        with pytest.raises(ValueError) as got:
            make_train_step_tp(ModelConfig(**geometry), port)
        jax_path = str(want.value).split(" hidden matrix ")[1].split(" with ")[0]
        assert "layer_1" in jax_path and "'w'" in jax_path
        assert str(got.value) == str(want.value).replace(jax_path, "layer_1/w")
    else:
        bind(jstate)
        make_train_step_tp(ModelConfig(**geometry), port)


# ---- real ranks ------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(workdir, world: int, n_model: int):
    """One worker process a rank, all started together, each killed after
    RANK_TIMEOUT_S; returns the JSON lines each printed."""
    port = str(free_port())
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), port, str(workdir),
                               str(n_model)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
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


def case_batch(seed: int, B: int, L: int = 4):
    """Rows of different lengths, frames and labels past them zero."""
    rs = np.random.RandomState(seed)
    feats = (rs.randn(B, T, GEOMETRY["n_input"]) * 2).astype(np.float32)
    feat_lens = rs.randint(T - 4, T + 1, size=B).astype(np.int32)
    feat_lens[0] = T
    labels = rs.randint(0, GEOMETRY["n_out"] - 1, size=(B, L)).astype(np.int32)
    label_lens = rs.randint(1, L + 1, size=B).astype(np.int32)
    for i in range(B):
        feats[i, feat_lens[i]:] = 0.0
        labels[i, label_lens[i]:] = 0
    return feats, feat_lens, labels, label_lens


CASES = {  # mesh -> {case: (batch seed, global B, dropout)}
    "1x2": {"main": (1, 16, 0.0)},
    "2x2": {"main": (2, 32, 0.0), "odd": (3, 6, 0.0), "dropout": (2, 32, 0.3)},
    "1x3": {"uneven": (4, 12, 0.0)},
}


def run_mesh(name: str, tmp_path_factory, geometry=GEOMETRY, replicate_uneven=False,
             trainer=None):
    """The ranks of one mesh on the cases of CASES[name]; with `trainer`
    (n_hidden, epochs, resume) they then run `train(config)` too."""
    n_data, n_model = MESHES[name]
    workdir = tmp_path_factory.mktemp(f"tp{name}")
    params = jax.device_get(init_params(jax.random.PRNGKey(0), JaxModelConfig(**geometry)))
    batches = {case: case_batch(seed, B) for case, (seed, B, _) in CASES[name].items()}
    arrays = {}
    for case, batch in batches.items():
        for key, value in zip(("feats", "feat_lens", "labels", "label_lens"), batch):
            arrays[f"case:{case}:{key}"] = value
        arrays[f"case:{case}:dropout"] = CASES[name][case][2]
    np.savez(workdir / "inputs.npz", lr=LR, geometry=json.dumps(geometry),
             replicate_uneven=replicate_uneven,
             **{f"param:{k}": v for k, v in flat(params).items()}, **arrays)
    data = None
    if trainer is not None:  # the trainer's runs
        n_hidden, epochs, resume = trainer
        rs = np.random.RandomState(0)
        alphabet = workdir / "alphabet.txt"
        alphabet.write_text("".join(label + "\n" for label in " abcdefgh"))
        data = {"train": write_csv(workdir / "train.csv", rs, 8),
                "dev": write_csv(workdir / "dev.csv", rs, 3), "alphabet": str(alphabet),
                "n_hidden": n_hidden, "epochs": epochs, "resume": resume}
        (workdir / "dataset.json").write_text(json.dumps(data))
    lines = run_ranks(workdir, n_data * n_model, n_model)
    return {"name": name, "mesh": (n_data, n_model), "workdir": workdir, "lines": lines,
            "params": params, "batches": batches, "data": data, "geometry": geometry}


@pytest.fixture(scope="module")
def mesh_1x2(tmp_path_factory):
    return run_mesh("1x2", tmp_path_factory, trainer=(64, 2, True))


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    return run_mesh("2x2", tmp_path_factory)


@pytest.fixture(scope="module")
def mesh_1x3(tmp_path_factory):
    """The uneven layout, as the trainer steps it; the trainer at n_hidden
    64 (no width divides by 3: every layer stays whole)."""
    return run_mesh("1x3", tmp_path_factory, UNEVEN_GEOMETRY, replicate_uneven=True,
                    trainer=(64, 1, False))


@pytest.fixture(params=["1x2", "2x2"])
def ranks(request):
    return request.getfixturevalue(f"mesh_{request.param}")


def of(lines, kind, **match):
    return [line for line in lines if line["kind"] == kind
            and all(line.get(k) == v for k, v in match.items())]


def saved(ranks, case, rank=0):
    return np.load(ranks["workdir"] / f"{case}.rank{rank}.npz")


def jax_tp_steps(params, arrays, mesh_shape, fused: bool):
    """stt_tpu's make_train_step_tp, three steps; (metrics, final params)."""
    n_data, n_model = mesh_shape
    mesh = jax_make_mesh(n_data, n_model)
    cfg = JaxModelConfig(**GEOMETRY, dropout_rates=(0.0,) * 6)
    optimizer = jax_create_optimizer(learning_rate=LR)
    state = jax_create_train_state(None, cfg, optimizer, params=params)
    from jax.sharding import NamedSharding

    state = state._replace(
        params=jax.device_put(state.params, param_sharding(mesh, state.params, True)),
        opt_state=jax.device_put(state.opt_state, jax.tree.map(
            lambda leaf: NamedSharding(mesh, jax_model_partition_spec(leaf, n_model)),
            state.opt_state)),
        step=jax.device_put(state.step, replicated(mesh)))
    batch = JaxBatch(*[jax.device_put(jnp.asarray(a), batch_sharding(mesh)) for a in arrays])
    with pytest.MonkeyPatch.context() as mp:
        if fused:
            mp.setenv("STT_TPU_TP_FUSED", "1")
        else:
            mp.delenv("STT_TPU_TP_FUSED", raising=False)
        step = jax_make_train_step_tp(cfg, optimizer, mesh)(state)
        metrics = []
        for _ in range(3):
            state, m = step(state, batch, jax.random.PRNGKey(9))
            metrics.append(m)
    return metrics, flat(jax.device_get(state.params))


def one_process_steps(params, arrays, geometry=GEOMETRY):
    """The port's one-process step on the global batch, three steps;
    (metrics, first step's gradients, final params)."""
    cfg = ModelConfig(**geometry, dropout_rates=(0.0,) * 6)
    state = create_train_state(cfg, device="cpu", model=params_from_numpy(params, cfg),
                               learning_rate=LR)
    step = make_train_step()
    metrics, grads = [], None
    for i in range(3):
        state, m = step(state, Batch(*map(torch.from_numpy, arrays)), 9)
        metrics.append(m)
        if i == 0:
            grads = {k: p.grad.clone().numpy() for k, p in state.model.named_parameters()}
    return metrics, grads, {k: v.detach().numpy() for k, v in state.params.items()}


def assert_ranks_agree(ranks, case):
    """Every rank: the same loss and gradient norm, its data index's
    per-example losses, and the same gathered parameters."""
    n_data, n_model = ranks["mesh"]
    steps = [of(lines, "step", case=case) for lines in ranks["lines"]]
    for rank_steps in steps[1:]:
        for a, b in zip(steps[0], rank_steps):
            assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for d in range(n_data):
        model_ranks = [steps[d * n_model + m] for m in range(n_model)]
        for other in model_ranks[1:]:
            assert [s["per_example"] for s in other] == [s["per_example"] for s in model_ranks[0]]
    first = saved(ranks, case)
    for r in range(1, n_data * n_model):
        other = saved(ranks, case, r)
        for key in first.files:
            np.testing.assert_array_equal(first[key], other[key], err_msg=key)
    return steps


def per_example(steps, n_data, n_model, i):
    """Step i's per-example losses over the global batch, by data index."""
    return np.concatenate([steps[d * n_model][i]["per_example"] for d in range(n_data)])


def test_tp_mesh_layout(ranks):
    n_data, n_model = ranks["mesh"]
    got = [of(lines, "mesh")[0] for lines in ranks["lines"]]
    assert [(g["data_index"], g["model_index"]) for g in got] == \
        [(r // n_model, r % n_model) for r in range(n_data * n_model)]
    B = CASES[ranks["name"]]["main"][1]
    rows = [of(lines, "step", case="main")[0]["rows"] for lines in ranks["lines"]]
    assert rows == [[(r // n_model) * B // n_data, (r // n_model + 1) * B // n_data]
                    for r in range(n_data * n_model)]


def test_tp_step_equals_stt_tpus_tp_step(ranks):
    n_data, n_model = ranks["mesh"]
    steps = assert_ranks_agree(ranks, "main")
    arrays = ranks["batches"]["main"]
    metrics, params = jax_tp_steps(ranks["params"], arrays, ranks["mesh"], fused=True)
    for i, m in enumerate(metrics):
        np.testing.assert_allclose(steps[0][i]["loss"], float(m.loss), rtol=2e-5)
        np.testing.assert_allclose(per_example(steps, n_data, n_model, i),
                                   np.asarray(m.per_example_loss), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(steps[0][i]["grad_norm"], float(m.grad_norm), rtol=1e-4)
    got = saved(ranks, "main")
    for name, value in params.items():
        np.testing.assert_allclose(got[f"param:{name}"], value, rtol=2e-3, atol=2e-3,
                                   err_msg=name)


def test_tp_step_equals_one_process_step_leaf_by_leaf(ranks):
    n_data, n_model = ranks["mesh"]
    steps = [of(lines, "step", case="main") for lines in ranks["lines"]]
    metrics, grads, params = one_process_steps(ranks["params"], ranks["batches"]["main"])
    np.testing.assert_allclose(steps[0][0]["loss"], metrics[0].loss.item(), rtol=1e-5)
    for i, m in enumerate(metrics):
        np.testing.assert_allclose(per_example(steps, n_data, n_model, i),
                                   m.per_example_loss.numpy(), rtol=1e-5)
        np.testing.assert_allclose(steps[0][i]["grad_norm"], m.grad_norm.item(), rtol=1e-5)
    got = saved(ranks, "main")
    assert sorted(k[len("grad:"):] for k in got.files if k.startswith("grad:")) == sorted(grads)
    for name, value in grads.items():
        np.testing.assert_allclose(got[f"grad:{name}"], value, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    for name, value in params.items():
        np.testing.assert_allclose(got[f"param:{name}"], value, rtol=1e-5, atol=1e-4,
                                   err_msg=name)


def test_tp_replicated_recurrence_branch(mesh_2x2):
    """3 rows a data index over 2 model ranks: the projection is gathered
    and each rank runs the recurrence on all 3 rows."""
    ranks = mesh_2x2
    n_data, n_model = ranks["mesh"]
    steps = assert_ranks_agree(ranks, "odd")
    arrays = ranks["batches"]["odd"]
    assert arrays[0].shape[0] // n_data % n_model
    metrics, grads, params = one_process_steps(ranks["params"], arrays)
    got = saved(ranks, "odd")
    for i, m in enumerate(metrics):
        np.testing.assert_allclose(steps[0][i]["loss"], m.loss.item(), rtol=1e-5)
        np.testing.assert_allclose(per_example(steps, n_data, n_model, i),
                                   m.per_example_loss.numpy(), rtol=1e-5)
    for name, value in grads.items():
        np.testing.assert_allclose(got[f"grad:{name}"], value, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    jmetrics, jparams = jax_tp_steps(ranks["params"], arrays, ranks["mesh"], fused=False)
    for i, m in enumerate(jmetrics):
        np.testing.assert_allclose(steps[0][i]["loss"], float(m.loss), rtol=2e-5)
        np.testing.assert_allclose(steps[0][i]["grad_norm"], float(m.grad_norm), rtol=1e-3)
    # three Adam steps move a parameter by at most about 3 lr whatever its
    # gradient, so the parameters are compared by their updates
    init = flat(ranks["params"])
    diff = sum(np.square(got[f"param:{k}"] - v).sum() for k, v in jparams.items())
    update = sum(np.square(v - init[k]).sum() for k, v in jparams.items())
    assert np.sqrt(diff / update) < 2e-2


def test_tp_dropout_masks_shared_by_model_ranks(mesh_2x2):
    ranks = mesh_2x2
    steps = assert_ranks_agree(ranks, "dropout")
    main = [of(lines, "step", case="main") for lines in ranks["lines"]]
    # the same batch as the main case: the masks are drawn
    assert steps[0][0]["loss"] != main[0][0]["loss"]
    assert np.all(np.isfinite([s["loss"] for s in steps[0]]))


def one_process_trainer(data, tmp_path, epochs: int, resume_from=None):
    """The losses of `train(config)` in one process on the trainer runs'
    data (then, with `resume_from`, those of one epoch resumed from that
    checkpoint) and its dev losses."""
    from stt_tpu_torch.train import trainer

    recorded = []
    made = trainer.make_train_step

    def recording_step():
        inner = made()

        def train_step(state, batch, seed=0):
            state, metrics = inner(state, batch, seed)
            recorded.append(metrics.loss.item())
            return state, metrics
        return train_step

    common = dict(train_files=[data["train"]], dev_files=[data["dev"]],
                  alphabet_config_path=data["alphabet"], n_hidden=data["n_hidden"],
                  train_batch_size=4, dev_batch_size=1, dropout_rate=0.0, learning_rate=0.003,
                  seed=1, input_workers=0, prefetch_batches=0)
    trainer.make_train_step = recording_step
    try:
        trainer.train(SttConfig(epochs=epochs, summary_dir=str(tmp_path / "summary"), **common),
                      device="cpu")
        first = list(recorded)
        recorded.clear()
        if resume_from is not None:
            trainer.train(SttConfig(epochs=1, load_checkpoint_dir=str(resume_from),
                                    save_checkpoint_dir=str(tmp_path / "resumed"), **common),
                          device="cpu")
    finally:
        trainer.make_train_step = made
    return first, recorded, dev_losses(tmp_path / "summary")


def dev_losses(summary_dir) -> list:
    return [json.loads(line)["dev/loss"] for line in
            (summary_dir / "scalars.jsonl").read_text().splitlines() if "dev/loss" in line]


def test_tp_trainer_equals_one_process_and_its_checkpoint_resumes(mesh_1x2, tmp_path):
    """train(config) with --num_processes 2 --n_model_parallel 2 against
    the same run in one process; its checkpoint (full parameters and Adam
    state) resumed by one process continues as the TP run resumed from it."""
    ranks = mesh_1x2
    data, workdir = ranks["data"], ranks["workdir"]
    lines = ranks["lines"]
    trained = [of(rank_lines, "train") for rank_lines in lines]
    ends = [[line["kind"] for line in rank_lines].index("trained") for rank_lines in lines]
    tp_first = [line for line in lines[0][:ends[0]] if line["kind"] == "train"]
    tp_resumed = [line for line in lines[0][ends[0]:] if line["kind"] == "train"]
    assert [t["loss"] for t in trained[0]] == [t["loss"] for t in trained[1]]
    assert all(t["rows"] == 4 for t in trained[0])

    one_first, recorded, want = one_process_trainer(data, tmp_path, 2, workdir / "ckpt")
    assert len(tp_first) == len(one_first) == 1 + 2 * 2  # the dummy run, 2 epochs x 2
    np.testing.assert_allclose(tp_first[0]["loss"], one_first[0], rtol=1e-5)
    np.testing.assert_allclose([t["loss"] for t in tp_first], one_first, rtol=1e-5)
    dev = dev_losses(workdir / "summary")
    assert len(dev) == len(want) == 2
    np.testing.assert_allclose(dev, want, rtol=1e-6)
    # the checkpoint holds full shapes, and one process resumes it as the TP run does
    record = torch.load(next((workdir / "ckpt" / "last").iterdir()) / "state.pt",
                        weights_only=True)
    shapes = param_shapes(ModelConfig(n_hidden=64, n_cell_dim=64, n_out=10))
    assert {k: tuple(v.shape) for k, v in record["params"].items()} == shapes
    assert record["step"] == 5
    assert len(tp_resumed) == len(recorded) == 1 + 2
    np.testing.assert_allclose([t["loss"] for t in tp_resumed], recorded, rtol=1e-5)


def jax_gspmd_steps(params, arrays, geometry, n_model: int):
    """stt_tpu's trainer step under --n_model_parallel: GSPMD's
    make_train_step over param_sharding (every layout; widths that do not
    divide stay replicated), three steps; (metrics, final params)."""
    from stt_tpu.train import make_train_step as jax_make_train_step

    mesh = jax_make_mesh(1, n_model)
    cfg = JaxModelConfig(**geometry, dropout_rates=(0.0,) * 6)
    optimizer = jax_create_optimizer(learning_rate=LR)
    state = jax_create_train_state(None, cfg, optimizer, params=params)
    state = state._replace(
        params=jax.device_put(state.params, param_sharding(mesh, state.params, True)),
        opt_state=jax.device_put(state.opt_state, replicated(mesh)),
        step=jax.device_put(state.step, replicated(mesh)))
    batch = JaxBatch(*[jax.device_put(jnp.asarray(a), replicated(mesh)) for a in arrays])
    step = jax.jit(jax_make_train_step(cfg, optimizer))
    metrics = []
    for _ in range(3):
        state, m = step(state, batch, jax.random.PRNGKey(9))
        metrics.append(m)
    return metrics, flat(jax.device_get(state.params))


def test_tp_uneven_layout_replicates_what_does_not_divide(mesh_1x3):
    """3 model ranks over widths 66 (layers 1, 2, 5: sharded) and 64
    (layer_3 and the LSTM, whose 4H = 256 does not divide either: whole on
    every rank, the LSTM as the one-process `lstm_train`), as the trainer
    steps them (`replicate_uneven`): the one-process step on the same batch,
    leaf by leaf, and stt_tpu's trainer step (GSPMD over param_sharding)."""
    ranks = mesh_1x3
    geometry = ranks["geometry"]
    steps = assert_ranks_agree(ranks, "uneven")
    arrays = ranks["batches"]["uneven"]
    with pytest.raises(ValueError, match="hidden matrix layer_3/w"):
        make_train_step_tp(ModelConfig(**geometry), Mesh(1, 3, 0))
    metrics, grads, params = one_process_steps(ranks["params"], arrays, geometry)
    got = saved(ranks, "uneven")
    for i, m in enumerate(metrics):
        np.testing.assert_allclose(steps[0][i]["loss"], m.loss.item(), rtol=1e-5)
        np.testing.assert_allclose(per_example(steps, 1, 3, i), m.per_example_loss.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(steps[0][i]["grad_norm"], m.grad_norm.item(), rtol=1e-5)
    assert sorted(k[len("grad:"):] for k in got.files if k.startswith("grad:")) == sorted(grads)
    for name, value in grads.items():
        np.testing.assert_allclose(got[f"grad:{name}"], value, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    for name, value in params.items():
        np.testing.assert_allclose(got[f"param:{name}"], value, rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    # stt_tpu's trainer runs its lax.scan here (n_cell 64 is no multiple of
    # 128): the first step's gradient norm is held, and the later steps'
    # only against the port's one-process step above, since Adam's first
    # update moves a parameter whose gradient is near 0 by about lr either way
    jmetrics, jparams = jax_gspmd_steps(ranks["params"], arrays, geometry, 3)
    np.testing.assert_allclose(steps[0][0]["grad_norm"], float(jmetrics[0].grad_norm), rtol=1e-4)
    for i, m in enumerate(jmetrics):
        np.testing.assert_allclose(steps[0][i]["loss"], float(m.loss), rtol=2e-5)
    init = flat(ranks["params"])
    diff = sum(np.square(got[f"param:{k}"] - v).sum() for k, v in jparams.items())
    update = sum(np.square(v - init[k]).sum() for k, v in jparams.items())
    assert np.sqrt(diff / update) < 2e-2


def test_tp_trainer_takes_a_width_that_does_not_divide(mesh_1x3, tmp_path):
    """train(config) with --num_processes 3 --n_model_parallel 3 at n_hidden
    64, which stt_tpu's trainer takes (every leaf replicated) and
    make_train_step_tp alone refuses: the one-process run's losses and dev
    loss."""
    ranks = mesh_1x3
    lines = ranks["lines"]
    trained = [of(rank_lines, "train") for rank_lines in lines]
    assert trained[0] and all([t["loss"] for t in r] == [t["loss"] for t in trained[0]]
                              for r in trained)
    one, _, want = one_process_trainer(ranks["data"], tmp_path, 1)
    assert len(trained[0]) == len(one) == 1 + 2  # the dummy run, 1 epoch x 2
    np.testing.assert_allclose([t["loss"] for t in trained[0]], one, rtol=1e-5)
    dev = dev_losses(ranks["workdir"] / "summary")
    assert len(dev) == len(want) == 1
    np.testing.assert_allclose(dev, want, rtol=1e-6)
