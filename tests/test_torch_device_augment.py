"""The port's on-device augmentation (`stt_tpu_torch.data.device_augment`)
against stt_tpu's `DeviceAugmentPipeline` on the same drawn parameters, on
the CPU; `create_batches` with device_augment and row_range against
stt_tpu's; and a training run with --graph_augs_on_device.

Tolerances: new lengths exactly; features within FEATURE_TOL = 2e-3
absolute and relative, stt_tpu's own hold of its pipeline against its host
transforms (tests/test_device_augment.py): the chain's interpolations are
the same float32 operations on both sides, the MFCC's products are summed in
another order (measured on these fixtures: at most 3.1e-5, against
features of up to 247 where a time mask zeroes whole spectrogram rows).
The random family (dropout, add, multiply) draws its noise from a torch
generator where stt_tpu draws from jax.random: held by determinism and
moments, as stt_tpu holds its own.
"""

import os

import numpy as np
import pytest
import torch

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.data import augmentations as jax_augs
from stt_tpu.data.device_augment import DeviceAugmentPipeline as JaxPipeline
from stt_tpu.data.feeding import create_batches as jax_create_batches
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.data import augmentations as augs
from stt_tpu_torch.data.device_augment import DeviceAugmentPipeline
from stt_tpu_torch.data.feeding import create_batches
from stt_tpu_torch.frontend import FeatureConfig, mfcc_from_spectrogram
from test_torch_trainer import dataset, tiny_config  # noqa: F401  (a fixture)

FC = FeatureConfig()
F = FC.n_bins
FEATURE_TOL = 2e-3


def make_batch(lens, width, seed=0):
    rng = np.random.RandomState(seed)
    t_max = ((max(lens) + 15) // 16) * 16
    batch = np.zeros((len(lens), t_max, width), np.float32)
    specs = []
    for i, n in enumerate(lens):
        s = np.abs(rng.randn(n, width)).astype(np.float32)
        specs.append(s)
        batch[i, :n] = s
    return specs, batch


def both(make):
    """The same augmentation list built from each package's classes."""
    return make(augs), make(jax_augs)


# tests/test_device_augment.py's augmentation lists, each the same in both packages
AUG_LISTS = {
    "pitch": lambda m: [m.Pitch(p=1.0, pitch="0.8:1.2")],
    "tempo": lambda m: [m.Tempo(p=1.0, factor="0.9:1.3")],
    "warp": lambda m: [m.Warp(p=1.0, num_t=2, num_f=2, warp_t=0.2, warp_f=0.1)],
    "frequency_mask": lambda m: [m.FrequencyMask(p=1.0, n=3, size=5)],
    "time_mask": lambda m: [m.TimeMask(p=1.0, n=2, size=60.0)],
    "time_mask_features": lambda m: [m.TimeMask(p=1.0, domain="features", n=2, size=40.0)],
    "chain": lambda m: [m.Pitch(p=1.0, pitch="0.9:1.1"), m.Tempo(p=1.0, factor="0.95:1.2"),
                        m.FrequencyMask(p=1.0, n=2, size=4),
                        m.TimeMask(p=1.0, domain="features", n=1, size=40.0)],
    "gate": lambda m: [m.Pitch(p=0.5, pitch="1.1")],  # some rows inactive
    "stretch": lambda m: [m.Tempo(p=1.0, factor="0.6:0.7")],  # clipped to the buffer
}


@pytest.mark.parametrize("name", list(AUG_LISTS))
def test_device_chain_equals_stt_tpu_on_the_same_parameters(name):
    port_augs, jax_list = both(AUG_LISTS[name])
    pipeline, jax_pipeline = DeviceAugmentPipeline(port_augs, FC), JaxPipeline(jax_list,
                                                                              JaxFeatureConfig())
    lens = [40, 25, 33, 48]
    _, batch = make_batch(lens, F, seed=3)
    ids, clocks = [f"s{i}" for i in range(4)], [0.1 * (i + 1) for i in range(4)]
    drawn = [jax_pipeline.draw_sample(ids[i], lens[i], clocks[i]) for i in range(4)]
    # both packages draw the same parameters (one process: one string hash)
    port_drawn = [pipeline.draw_sample(ids[i], lens[i], clocks[i]) for i in range(4)]
    for a, b in zip(port_drawn, drawn):
        for (act_a, pa), (act_b, pb) in zip(a, b):
            assert act_a == act_b and pa.keys() == pb.keys()
            for k in pa:
                np.testing.assert_array_equal(pa[k], pb[k])
    params = jax_pipeline.stack(drawn)
    want, want_lens = (np.asarray(v) for v in jax_pipeline.jitted()(batch, np.asarray(lens), params))
    got, got_lens = pipeline.apply(torch.from_numpy(batch), torch.tensor(lens), params)
    np.testing.assert_array_equal(got_lens.numpy(), want_lens)
    assert got_lens.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=FEATURE_TOL, atol=FEATURE_TOL)
    for i, n in enumerate(got_lens.tolist()):
        assert not got[i, n:].any()  # padding rows are exact zeros


def test_random_family_is_deterministic_with_the_right_moments():
    lens = [200, 180]
    specs, batch = make_batch(lens, F, seed=5)
    ids, clocks = ["a", "b"], [0.2, 0.4]
    x, n = torch.from_numpy(batch), torch.tensor(lens)
    clean = mfcc_from_spectrogram(torch.from_numpy(specs[0]), FC).numpy()

    pipeline = DeviceAugmentPipeline([augs.Dropout(p=1.0, domain="features", rate=0.25)], FC)
    params = pipeline.draw(ids, lens, clocks)
    f1, _ = pipeline.apply(x, n, params)
    f2, _ = pipeline.apply(x, n, params)
    assert torch.equal(f1, f2)
    frac = (f1[0, :lens[0]] == 0.0).float().mean().item()
    assert 0.15 < frac < 0.35, frac
    other = pipeline.draw(["c", "d"], lens, clocks)
    assert not torch.equal(pipeline.apply(x, n, other)[0], f1)  # another seed, other masks

    pipeline = DeviceAugmentPipeline([augs.Add(p=1.0, domain="features", stddev=2.0)], FC)
    noised = pipeline.apply(x, n, pipeline.draw(ids, lens, clocks))[0][0, :lens[0]].numpy()
    delta = noised - clean
    assert 1.5 < delta.std() < 2.5 and abs(delta.mean()) < 0.1, (delta.std(), delta.mean())

    pipeline = DeviceAugmentPipeline([augs.Multiply(p=1.0, domain="features", stddev=0.1)], FC)
    mult = pipeline.apply(x, n, pipeline.draw(ids, lens, clocks))[0][0, :lens[0]].numpy()
    ratio = mult / np.where(np.abs(clean) < 1e-6, 1.0, clean)
    assert abs(np.median(ratio) - 1.0) < 0.05 and 0.07 < ratio.std() < 0.13


def test_no_augmentations_give_plain_mfcc():
    pipeline = DeviceAugmentPipeline([], FC)
    assert not pipeline.has_work()
    lens = [30, 22]
    specs, batch = make_batch(lens, F, seed=9)
    feats, new_lens = pipeline.apply(torch.from_numpy(batch), torch.tensor(lens), [])
    assert new_lens.tolist() == lens
    for i, n in enumerate(lens):
        np.testing.assert_allclose(feats[i, :n].numpy(),
                                   mfcc_from_spectrogram(torch.from_numpy(specs[i]), FC).numpy(),
                                   rtol=0, atol=1e-6)
        assert not feats[i, n:].any()


SPECS = ["tempo[p=0.8,factor=0.9:1.1]", "frequency_mask[n=2,size=3]", "pitch[p=0.5,pitch=0.9:1.1]",
         "time_mask[domain=features,n=1,size=30]", "volume[dbfs=-20:-3]"]


@pytest.mark.parametrize("kw", [dict(batch_size=3), dict(batch_size=2, row_range=(1, 2)),
                                dict(batch_size=3, row_range=(0, 2), num_workers=2, prefetch=1)])
def test_create_batches_with_device_augment_matches_jax(dataset, kw):  # noqa: F811
    """Spectrogram batches (rate, sample and signal augmentations on the
    host), the drawn parameters and the rows of row_range equal stt_tpu's;
    the spectrograms within the frontends' 1e-4."""
    port_augs = augs.parse_augmentations(SPECS)
    jax_list = jax_augs.parse_augmentations(SPECS)
    got = list(create_batches([dataset["train"]], Alphabet(dataset["alphabet"]), FC,
                              augmentations=port_augs, train_phase=True, epoch=1, total_epochs=2,
                              device_augment=DeviceAugmentPipeline(port_augs, FC), **kw))
    want = list(jax_create_batches([dataset["train"]], JaxAlphabet(dataset["alphabet"]),
                                   JaxFeatureConfig(), augmentations=jax_list, train_phase=True,
                                   epoch=1, total_epochs=2,
                                   device_augment=JaxPipeline(jax_list, JaxFeatureConfig()), **kw))
    assert len(got) == len(want) > 0
    for (batch, ids, params), (jbatch, jids, jparams) in zip(got, want):
        assert ids == jids
        assert batch.features.shape[2] == F
        np.testing.assert_allclose(batch.features.numpy(), np.asarray(jbatch.features),
                                   rtol=1e-4, atol=1e-4)
        for a, b in zip(batch[1:], jbatch[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert len(params) == len(jparams) == 4  # the graph augmentations, in chain order
        for p, jp in zip(params, jparams):
            assert p.keys() == jp.keys()
            for k in p:
                np.testing.assert_array_equal(p[k], jp[k])
    if "row_range" in kw:
        start, end = kw["row_range"]
        full = list(create_batches([dataset["train"]], Alphabet(dataset["alphabet"]), FC,
                                   batch_size=kw["batch_size"], train_phase=True, epoch=1,
                                   total_epochs=2))
        shares = [ids[start:end] for _, ids in full if ids[start:end]]
        assert [ids for _, ids, _ in got] == shares


def test_training_with_graph_augs_on_device(dataset):  # noqa: F811
    """--graph_augs_on_device on the CPU: the spectrogram and features
    augmentations run in the device pass before each step, the losses stay
    finite and the steps advance (the dummy run and the epochs' batches)."""
    from stt_tpu_torch.train.trainer import train

    config = tiny_config(dataset, epochs=2, augment=SPECS + ["dropout[domain=features,rate=0.02]"],
                         graph_augs_on_device=True, input_workers=2, prefetch_batches=1,
                         summary_dir=str(dataset["dir"] / "summary"))
    state = train(config, device="cpu")
    assert state.step == 1 + 2 * 3  # the dummy run, then 2 epochs of 3 batches
    lines = (dataset["dir"] / "summary" / "scalars.jsonl").read_text().splitlines()
    losses = [float(line.split('"train/step_loss": ')[1].split("}")[0].split(",")[0])
              for line in lines if "train/step_loss" in line]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert os.path.exists(dataset["dir"] / "summary" / "scalars.jsonl")
