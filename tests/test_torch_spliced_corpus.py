"""The port's make_spliced_corpus (stt_tpu_torch/bin/make_spliced_corpus.py)
against bin/make_spliced_corpus.py, on the CPU:

- align_words on the same weights (a small model trained here by the port
  on the smoke utterance of `chip_smoke.write_smoke_set`, carried to
  stt_tpu's checkpoint format) and audio: the same words, and clips equal
  sample for sample;
- both scripts' main on that alignment and one seed write byte-equal WAVs
  and CSVs (speed perturbation through each package's resample).
"""

import os
import shutil
import sys

import numpy as np
import pytest

import jax
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def smoke_set(tmp_path_factory):
    return chip_smoke.write_smoke_set(str(tmp_path_factory.mktemp("data")), 0)


SPLICE_N_HIDDEN = 64
SPLICE_STEPS = 300  # at most
SPLICE_LR = 0.003


@pytest.fixture(scope="module")
def aligned_checkpoints(smoke_set, tmp_path_factory):
    """A small model trained by the port (f32, dropout off; checked every 10
    steps, ~120 here) until the beam decoder reads the smoke sentence from
    the utterance, saved as the
    port's best_dev checkpoint and, carried across, as stt_tpu's."""
    from stt_tpu.config import initialize_globals_from_cli as jax_cli
    from stt_tpu.models import ModelConfig as JaxModelConfig
    from stt_tpu.train import create_train_state as jax_create_train_state
    from stt_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
    from stt_tpu.train.trainer import create_optimizer_with_hyperparams
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import params_to_numpy
    from stt_tpu_torch.data.audio import read_wav
    from stt_tpu_torch.decode import ctc_beam_search_decoder
    from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc_numpy
    from stt_tpu_torch.models import ModelConfig
    from stt_tpu_torch.train import Batch, create_train_state, make_train_step
    from stt_tpu_torch.train.checkpoints import CheckpointManager

    root = tmp_path_factory.mktemp("ckpt")
    alphabet = Alphabet(smoke_set["alphabet"])
    audio, _ = read_wav(os.path.join(smoke_set["smoke"], "LDC93S1.wav"))
    feats = audio_to_mfcc_numpy(audio, FeatureConfig())[None]
    labels = np.asarray([alphabet.encode(chip_smoke.SMOKE_TRANSCRIPT)], np.int32)
    batch = Batch(torch.from_numpy(feats), torch.tensor([feats.shape[1]], dtype=torch.int32),
                  torch.from_numpy(labels), torch.tensor([labels.shape[1]], dtype=torch.int32))
    geometry = dict(n_hidden=SPLICE_N_HIDDEN, n_cell_dim=SPLICE_N_HIDDEN, n_out=alphabet.size + 1,
                    dropout_rates=(0.0,) * 6)
    torch.manual_seed(0)
    state = create_train_state(ModelConfig(**geometry), seed=0, device="cpu",
                               learning_rate=SPLICE_LR)
    step = make_train_step()
    for _ in range(SPLICE_STEPS // 10):
        for _ in range(10):
            step(state, batch, 0)
        with torch.no_grad():
            logits, _ = state.model(batch.features, seq_len=batch.feature_lengths)
        [res] = ctc_beam_search_decoder(torch.softmax(logits[0], -1).numpy(), alphabet, 64)
        if res.transcript == chip_smoke.SMOKE_TRANSCRIPT:
            break
    assert res.transcript == chip_smoke.SMOKE_TRANSCRIPT, res.transcript
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    CheckpointManager(port_dir).save(state, "best_dev", dev_loss=1.0)
    jax_cfg = JaxModelConfig(**geometry)
    # the optimizer of the template that stt_tpu's align_words restores into
    optimizer = create_optimizer_with_hyperparams(
        jax_cli(cli(str(root / "jax"), smoke_set["alphabet"])))
    params = params_to_numpy(state.model)
    jax_state = jax_create_train_state(jax.random.PRNGKey(0), jax_cfg, optimizer,
                                       params=jax.tree_util.tree_map(np.asarray, params))
    JaxCheckpointManager(jax_dir).save(jax_state, "best_dev", dev_loss=1.0)
    return {"port": port_dir, "jax": jax_dir, "audio": audio}


def cli(checkpoint_dir: str, alphabet: str) -> list:
    return ["--checkpoint_dir", checkpoint_dir, "--alphabet_config_path", alphabet,
            "--n_hidden", str(SPLICE_N_HIDDEN)]


def stt_tpus_splicer():
    sys.path.insert(0, os.path.join(ROOT, "bin"))
    try:
        import make_spliced_corpus
    finally:
        sys.path.remove(os.path.join(ROOT, "bin"))
    return make_spliced_corpus


def test_align_words_matches_stt_tpus(smoke_set, aligned_checkpoints):
    from stt_tpu.config import initialize_globals_from_cli as jax_cli
    from stt_tpu_torch.bin import make_spliced_corpus
    from stt_tpu_torch.config import initialize_globals_from_cli

    audio = aligned_checkpoints["audio"]
    theirs = stt_tpus_splicer()
    want_words, want_clips = theirs.align_words(
        jax_cli(cli(aligned_checkpoints["jax"], smoke_set["alphabet"])), audio)
    words, clips = make_spliced_corpus.align_words(
        initialize_globals_from_cli(cli(aligned_checkpoints["port"], smoke_set["alphabet"]),
                                    device="cpu"), audio, "cpu")
    assert " ".join(words) == chip_smoke.SMOKE_TRANSCRIPT
    assert words == want_words and list(clips) == list(want_clips)
    for word, clip in clips.items():
        np.testing.assert_array_equal(clip, want_clips[word])


def test_splice_writes_stt_tpus_corpus(smoke_set, aligned_checkpoints, tmp_path, monkeypatch):
    """Both scripts' main, given one alignment (the port's) and one seed,
    write the same bytes: every WAV and both CSVs."""
    from stt_tpu_torch.bin import make_spliced_corpus

    audio = aligned_checkpoints["audio"]
    alignment = make_spliced_corpus.align_words(
        make_spliced_corpus.initialize_globals_from_cli(
            cli(aligned_checkpoints["port"], smoke_set["alphabet"]), device="cpu"), audio, "cpu")
    smoke_wav = os.path.join(smoke_set["smoke"], "LDC93S1.wav")
    out_dir = str(tmp_path / "corpus")
    args = ["--out_dir", out_dir, "--n_train", "6", "--n_dev", "3", "--seed", "3",
            "--train_speakers", "0.97,1.0,1.03", "--dev_speakers", "0.90,1.10"]
    theirs = stt_tpus_splicer()
    monkeypatch.setattr(theirs, "SMOKE_WAV", smoke_wav)
    monkeypatch.setattr(theirs, "align_words", lambda config, audio: alignment)
    monkeypatch.setattr(sys, "argv", ["make_spliced_corpus.py", *args,
                                      *cli(aligned_checkpoints["jax"], smoke_set["alphabet"])])
    theirs.main()
    want = {}
    for dirpath, _, names in os.walk(out_dir):
        for name in names:
            path = os.path.join(dirpath, name)
            want[os.path.relpath(path, out_dir)] = read_bytes(path)
    shutil.rmtree(out_dir)
    monkeypatch.setattr(make_spliced_corpus, "align_words", lambda config, audio, device: alignment)
    make_spliced_corpus.main([*args, "--smoke_wav", smoke_wav, "--device", "cpu",
                              *cli(aligned_checkpoints["port"], smoke_set["alphabet"])])
    got = {}
    for dirpath, _, names in os.walk(out_dir):
        for name in names:
            path = os.path.join(dirpath, name)
            got[os.path.relpath(path, out_dir)] = read_bytes(path)
    assert sorted(got) == sorted(want) and len(got) == 2 + 6 + 3
    for name in want:
        assert got[name] == want[name], name
    rows = got["train.csv"].decode().splitlines()
    assert rows[1] == f"{smoke_wav},93638,{chip_smoke.SMOKE_TRANSCRIPT}"


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
