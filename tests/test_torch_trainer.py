"""The port's data feeding, checkpoints, config and training driver, on the
CPU at a tiny width:

- `create_batches` against `stt_tpu.data.feeding.create_batches` on one
  CSV of synthetic WAVs: batch order, labels and lengths exactly equal,
  features within 1e-4 (the port's torch frontend against the JAX
  package's numpy frontend; the frontends agree to ~2e-6 relative and
  MFCCs here reach ~50);
- a tiny run whose training loss falls;
- the checkpoint layout, retention, half-written saves, a resume that
  continues the step counter, --force_initialize_learning_rate, best_dev,
  early stop and the plateau;
- flag parsing against `stt_tpu.config.parse_flags`, the flags that are
  not ported, and `python -m stt_tpu_torch.train`;
- SDB sources and augmented batches against stt_tpu's, and a CPU run with
  augmentations, the feature cache, input workers and a profiler trace.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stt_tpu.config import parse_flags as jax_parse_flags
from stt_tpu.data.feeding import create_batches as jax_create_batches
from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.config import SttConfig, parse_flags
from stt_tpu_torch.data.feeding import create_batches
from stt_tpu_torch.data.sources import CSVWriter, Sample, samples_from_sources
from stt_tpu_torch.frontend import FeatureConfig
from stt_tpu_torch.train.checkpoints import (
    CheckpointManager,
    drop_layers,
    load_graph_for_evaluation,
    load_or_init_graph_for_training,
)
from stt_tpu_torch.train.step import create_train_state
from stt_tpu_torch.train.trainer import get_learning_rate, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = list(" abcdefgh")
FEATURE_TOL = 1e-4


def utterance(rs, seconds):
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    audio = sum(rs.uniform(0.05, 0.2) * np.sin(2 * np.pi * rs.uniform(90, 400) * t)
                for _ in range(3)) + 0.02 * rs.randn(n)
    return np.clip(audio, -1, 1).astype(np.float32)


def write_csv(path, rs, n, seconds=(0.4, 1.0)):
    with CSVWriter(str(path)) as writer:
        for i in range(n):
            text = "".join(rs.choice(LABELS[1:], rs.randint(2, 5)))
            writer.add(Sample(f"s{i}", text, _audio=utterance(rs, rs.uniform(*seconds)),
                              _rate=16000))
    return str(path)


@pytest.fixture
def dataset(tmp_path):
    rs = np.random.RandomState(0)
    alphabet = tmp_path / "alphabet.txt"
    alphabet.write_text("".join(label + "\n" for label in LABELS))
    return {
        "train": write_csv(tmp_path / "train.csv", rs, 7),
        "dev": write_csv(tmp_path / "dev.csv", rs, 3),
        "alphabet": str(alphabet),
        "dir": tmp_path,
    }


def tiny_config(dataset, **kw):
    args = dict(
        train_files=[dataset["train"]], dev_files=[dataset["dev"]],
        alphabet_config_path=dataset["alphabet"], n_hidden=32, train_batch_size=3,
        dev_batch_size=2, epochs=1, dropout_rate=0.0, learning_rate=0.003, seed=1,
    )
    args.update(kw)
    return SttConfig(**args)


@pytest.mark.parametrize("kw", [
    dict(batch_size=3),
    dict(batch_size=3, train_phase=True, epoch=1),
    dict(batch_size=2, train_phase=True, epoch=0, drop_remainder=True),
    dict(batch_size=2, reverse=True, limit=4),
    dict(batch_size=3, device_featurize=True),
])
def test_create_batches_matches_jax(dataset, kw):
    want = list(jax_create_batches([dataset["train"]], JaxAlphabet(dataset["alphabet"]),
                                   JaxFeatureConfig(), **kw))
    got = list(create_batches([dataset["train"]], Alphabet(dataset["alphabet"]),
                              FeatureConfig(), **kw))
    assert [ids for _, ids in got] == [ids for _, ids in want]
    for (batch, _), (jbatch, _) in zip(got, want):
        for name in ("feature_lengths", "labels", "label_lengths"):
            np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                          np.asarray(getattr(jbatch, name)), err_msg=name)
        assert batch.features.shape == jbatch.features.shape
        atol = 0 if kw.get("device_featurize") else FEATURE_TOL
        np.testing.assert_allclose(batch.features.numpy(), np.asarray(jbatch.features),
                                   rtol=0, atol=atol)


def test_sources_merge_and_refuse_what_is_not_ported(dataset):
    """Sources merge by duration; an SDB of the CSV's samples reads as
    stt_tpu reads it, and augmented batches from it equal stt_tpu's
    (labels exactly, features within FEATURE_TOL); an unknown source type
    is refused by both packages."""
    from stt_tpu.data.augmentations import parse_augmentations as jax_parse_augmentations
    from stt_tpu.data.sources import samples_from_sources as jax_samples_from_sources
    from stt_tpu_torch.data.augmentations import parse_augmentations
    from stt_tpu_torch.data.sources import SDBWriter

    merged = list(samples_from_sources([dataset["train"], dataset["dev"]]))
    assert len(merged) == 10
    hints = [s.duration_hint for s in merged]
    assert hints == sorted(hints)
    sdb = str(dataset["dir"] / "train.sdb")
    with SDBWriter(sdb) as writer:
        for sample in samples_from_sources([dataset["train"]]):
            writer.add(sample)
    got, want = list(samples_from_sources([sdb])), list(jax_samples_from_sources([sdb]))
    assert [(s.sample_id, s.transcript, s.rate) for s in got] == [
        (s.sample_id, s.transcript, s.rate) for s in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.audio, b.audio)
    specs = ["volume[p=0.8,dbfs=-20:-3]", "frequency_mask[n=2,size=3]", "time_mask[n=1,size=40]"]
    kw = dict(batch_size=3, train_phase=True, epoch=1, total_epochs=3)
    want = list(jax_create_batches([sdb], JaxAlphabet(dataset["alphabet"]), JaxFeatureConfig(),
                                   augmentations=jax_parse_augmentations(specs), **kw))
    got = list(create_batches([sdb], Alphabet(dataset["alphabet"]), FeatureConfig(),
                              augmentations=parse_augmentations(specs), **kw))
    assert [ids for _, ids in got] == [ids for _, ids in want]
    for (batch, _), (jbatch, _) in zip(got, want):
        np.testing.assert_array_equal(batch.labels.numpy(), np.asarray(jbatch.labels))
        np.testing.assert_array_equal(batch.feature_lengths.numpy(),
                                      np.asarray(jbatch.feature_lengths))
        np.testing.assert_allclose(batch.features.numpy(), np.asarray(jbatch.features),
                                   rtol=0, atol=FEATURE_TOL)
    for samples in (samples_from_sources, jax_samples_from_sources):
        with pytest.raises(ValueError, match="unknown dataset source type"):
            list(samples([str(dataset["dir"] / "x.json")]))


def test_training_loss_falls_and_checkpoints_are_laid_out(dataset):
    ckpt = dataset["dir"] / "ckpt"
    summary = dataset["dir"] / "summary"
    state = train(tiny_config(dataset, epochs=12, checkpoint_dir=str(ckpt),
                              summary_dir=str(summary), max_to_keep=2), device="cpu")
    # one dummy step, then three batches an epoch
    assert state.step == 1 + 12 * 3
    rows = [json.loads(line) for line in open(summary / "scalars.jsonl")]
    epoch_losses = [r["train/epoch_loss"] for r in rows if "train/epoch_loss" in r]
    assert len(epoch_losses) == 12 and np.isfinite(epoch_losses).all()
    assert epoch_losses[-1] < 0.5 * epoch_losses[0], epoch_losses
    assert sorted(os.listdir(ckpt)) == ["alphabet.txt", "best_dev", "config.json", "last",
                                        "meta.json"]
    meta = json.load(open(ckpt / "meta.json"))
    manager = CheckpointManager(str(ckpt), max_to_keep=2)
    assert meta["last"] == state.step and manager.steps("last") == [state.step - 3, state.step]
    assert meta["best_dev"] == manager.latest_step("best_dev")
    assert meta["best_dev_dev_loss"] == manager.best_dev_loss() < float("inf")
    assert json.load(open(ckpt / "config.json"))["n_hidden"] == 32
    # a half-written save is skipped
    os.makedirs(ckpt / "last" / f"step_{state.step + 5}.tmp-123")
    assert manager.latest_step("last") == state.step
    saved = manager.read("last")
    for name, value in state.params.items():
        assert torch.equal(saved["params"][name], value.detach())


def test_resume_continues_the_step_and_resets_the_learning_rate(dataset):
    ckpt = str(dataset["dir"] / "ckpt")
    first = train(tiny_config(dataset, epochs=1, checkpoint_dir=ckpt), device="cpu")
    assert first.step == 4
    # shrink the saved learning rate, as a plateau would have
    manager = CheckpointManager(ckpt)
    saved = manager.read("last")
    saved["opt_state"]["param_groups"][0]["lr"] = 1e-5
    torch.save(saved, os.path.join(ckpt, "last", "step_4", "state.pt"))

    resumed = train(tiny_config(dataset, epochs=1, checkpoint_dir=ckpt, load_train="last"),
                    device="cpu")
    assert resumed.step == 8
    assert get_learning_rate(resumed) == pytest.approx(1e-5)
    reset = train(tiny_config(dataset, epochs=1, checkpoint_dir=ckpt, load_train="last",
                              force_initialize_learning_rate=True), device="cpu")
    assert reset.step == 12 and get_learning_rate(reset) == pytest.approx(0.003)


def test_early_stop_and_plateau(dataset, capsys):
    ckpt = str(dataset["dir"] / "ckpt")
    # a learning rate of 0 never improves the dev loss: every epoch after
    # the first counts as one without improvement
    state = train(tiny_config(dataset, epochs=10, learning_rate=0.0, checkpoint_dir=ckpt,
                              early_stop=True, es_epochs=3, reduce_lr_on_plateau=True,
                              plateau_epochs=2, plateau_reduction=0.5), device="cpu")
    out = capsys.readouterr().out
    assert "Early stop triggered" in out
    assert out.count("Plateau: reloaded best checkpoint") == 1
    # epoch 0 (steps 2-4) improves on inf and saves best_dev at step 4;
    # epochs 1 and 2 do not improve, so the plateau after epoch 2 reloads
    # step 4, as the JAX trainer does; epoch 3 is the third without an
    # improvement and stops the run at step 4 + 3
    assert state.step == 7
    assert CheckpointManager(ckpt).steps("best_dev") == [4]


def test_drop_layers_and_load_orders(tmp_path):
    from stt_tpu_torch.models import ModelConfig

    config = ModelConfig(n_hidden=16, n_cell_dim=16, n_out=5)
    trained = create_train_state(config, seed=1, device="cpu")
    trained.step = 7
    manager = CheckpointManager(str(tmp_path))
    manager.save(trained, "last")
    fresh = create_train_state(config, seed=2, device="cpu")
    fresh_params = {k: v.detach().clone() for k, v in fresh.params.items()}
    state, method = load_or_init_graph_for_training(manager, fresh, drop_source_layers=2)
    assert method == "last" and state.step == 0
    for name, value in state.params.items():
        source = fresh_params if name.split("/")[0] in ("layer_6", "layer_5") else trained.params
        assert torch.equal(value.detach(), source[name].detach()), name
    dropped = drop_layers(fresh_params, {k: v.detach() for k, v in trained.params.items()}, 9)
    assert torch.equal(dropped["layer_1/w"], trained.params["layer_1/w"].detach())
    assert torch.equal(dropped["layer_2/w"], fresh_params["layer_2/w"])

    state, method = load_graph_for_evaluation(manager, create_train_state(config, device="cpu"))
    assert method == "last" and state.step == 7
    with pytest.raises(FileNotFoundError):
        load_or_init_graph_for_training(manager, fresh, load_train="best")
    assert load_or_init_graph_for_training(CheckpointManager(str(tmp_path / "none")), fresh)[1] == "init"


ARGV = ["--train_files", "a.csv,b.csv", "--dev_files", "d.csv", "--n_hidden", "64",
        "--early_stop", "--dropout_rate", "0.1", "--dropout_rate3", "0.2", "--epochs", "3",
        "--compute_dtype", "bfloat16", "--checkpoint_dir", "/tmp/ck", "--shuffle_batches",
        "false", "--learning_rate", "0.0005"]


def test_flags_parse_like_the_jax_package():
    got = parse_flags(ARGV).to_dict()
    want = jax_parse_flags(ARGV).to_dict()
    assert set(got) == set(want)
    assert got == want
    assert got["dropout_rate2"] == 0.1 and got["dropout_rate3"] == 0.2
    assert got["load_checkpoint_dir"] == got["save_checkpoint_dir"] == "/tmp/ck"


@pytest.mark.parametrize("argv", [
    ["--export_tflite", "true"],
    ["--export_tflite", "true", "--export_file_name", "graph", "--n_steps", "8"],
])
def test_export_tflite_flags_parse_like_the_jax_package(argv):
    """The flags of the reference-format export, once refused, now parse
    to stt_tpu's values; no flag is left unported."""
    from stt_tpu_torch.config import NOT_PORTED

    assert NOT_PORTED == {}
    got = parse_flags(argv).to_dict()
    assert got == jax_parse_flags(argv).to_dict()
    assert got["export_tflite"] is True


@pytest.mark.parametrize("argv", [
    ["--graph_augs_on_device", "true", "--augment", "tempo[factor=0.9:1.1]"],
    ["--coordinator_address", "localhost:1234"],
    ["--num_processes", "2"],
    ["--process_id", "0"],
    ["--num_processes", "2", "--process_id", "1", "--coordinator_address", "localhost:1234"],
    ["--n_model_parallel", "2"],
])
def test_device_augment_and_multi_process_flags_parse_like_the_jax_package(argv):
    """The flags of on-device augmentation (M12) and of data and tensor
    parallelism across processes (M13) are ported: they parse as stt_tpu
    parses them, and parsing alone joins no process group."""
    import torch.distributed as dist

    got, want = parse_flags(argv).to_dict(), jax_parse_flags(argv).to_dict()
    assert got == want
    assert any(got[k] != SttConfig().to_dict()[k] for k in got)
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv", [
    ["--augment", "volume", "--augment", "tempo[p=0.5,factor=0.9:1.1]"],
    ["--feature_cache", "/tmp/c"],
    ["--cache_for_epochs", "2", "--input_workers", "4", "--prefetch_batches", "3"],
    ["--profile_dir", "/tmp/p", "--profile_steps", "3"],
])
def test_input_and_profiler_flags_parse_like_the_jax_package(argv):
    got, want = parse_flags(argv).to_dict(), jax_parse_flags(argv).to_dict()
    assert got == want
    assert any(got[k] != SttConfig().to_dict()[k] for k in got)


def test_training_with_augmentations_feature_cache_and_profiler(dataset):
    """Three epochs with every host augmentation but codec and overlay, the
    feature cache (filled in epoch 0, served in epoch 1, dropped at epoch 2
    by cache_for_epochs 2), 3 input workers and a profiler trace of the
    first steps: losses are finite, the cache file holds every row, the
    trace exists."""
    cache = dataset["dir"] / "features.cache"
    profile = dataset["dir"] / "profile"
    summary = dataset["dir"] / "summary"
    augment = ["reverb[p=0.5,delay=20,decay=10]", "resample[p=0.5,rate=8000]",
               "volume[dbfs=-20:-3]", "pitch[p=0.5,pitch=0.9:1.1]", "tempo[p=0.5,factor=0.9:1.1]",
               "warp[p=0.5]", "frequency_mask[n=2,size=3]", "time_mask[n=1,size=40]",
               "dropout[p=0.5,rate=0.05]", "add[p=0.5,stddev=0.1]", "multiply[p=0.5,stddev=0.05]"]
    config = tiny_config(dataset, n_hidden=64, epochs=3, augment=augment,
                         feature_cache=str(cache), cache_for_epochs=2, input_workers=3,
                         prefetch_batches=2, profile_dir=str(profile), profile_steps=2,
                         summary_dir=str(summary))
    state = train(config, device="cpu")
    assert state.step == 1 + 3 * 3
    with open(summary / "scalars.jsonl") as f:
        losses = [r["train/step_loss"] for r in map(json.loads, f) if "train/step_loss" in r]
    assert len(losses) == 9 and np.isfinite(losses).all()
    assert cache.is_file()
    from stt_tpu.data.feature_cache import FeatureCache as JaxFeatureCache

    assert JaxFeatureCache(str(cache)).complete  # epoch 2 refilled it; stt_tpu reads it
    trace = profile / "trace.json"
    assert trace.is_file()
    events = json.loads(trace.read_text())["traceEvents"]
    assert events
    # the program's spans are the trace's ranges by layer
    names = {e.get("name") for e in events}
    assert {"train.step", "ctc.loss", "train.backward", "ctc.loss.bwd"} <= names


def test_scorer_path_passes_preflight_or_raises(tmp_path):
    """--scorer_path is ported: the flag parses, the pre-flight loads a
    valid package and raises on an invalid one, as stt_tpu's does."""
    from stt_tpu.train.trainer import early_training_checks as jax_early_training_checks
    from stt_tpu_torch.train.trainer import early_training_checks
    from test_torch_scorer import build_package, write_inputs

    alphabet = write_inputs(tmp_path)["alphabet"]
    good = build_package(tmp_path, "lm.scorer")
    bad = str(tmp_path / "bad.scorer")
    with open(bad, "wb") as f:
        f.write(b"\0" * 256)
    for path in (good, bad):
        argv = ["--scorer_path", path, "--alphabet_config_path", alphabet]
        config, jax_config = parse_flags(argv), jax_parse_flags(argv)
        assert config.scorer_path == jax_config.scorer_path == path
        if path == good:
            early_training_checks(config)
            jax_early_training_checks(jax_config)
        else:
            with pytest.raises(ValueError, match="KenLM"):
                early_training_checks(config)
            with pytest.raises(ValueError, match="KenLM"):
                jax_early_training_checks(jax_config)
            with pytest.raises(ValueError, match="KenLM"):
                train(config, device="cpu")  # before any step


def test_train_module_runs_on_the_cpu_when_asked(dataset):
    args = ["--device", "cpu", "--train_files", dataset["train"], "--alphabet_config_path",
            dataset["alphabet"], "--n_hidden", "16", "--train_batch_size", "4", "--epochs", "1",
            "--checkpoint_dir", str(dataset["dir"] / "cli")]
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "stt_tpu_torch.train", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "Epoch 0 | train loss" in proc.stdout
    assert json.load(open(dataset["dir"] / "cli" / "meta.json"))["last"] == 3
    # without --device the card is asked for, and there is none here
    proc = subprocess.run([sys.executable, "-m", "stt_tpu_torch.train", *args[2:]], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
