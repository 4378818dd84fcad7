"""The port's augmentations, feature cache and threaded input pipeline
against stt_tpu's, on the CPU:

- every augmentation spec parses to the same augmentation;
- each augmentation, on the same input with the same seeded RNG, gives
  stt_tpu's output exactly (they are copies, numpy on the host), and so do
  `apply_sample_augmentations` / `apply_graph_augmentations`;
- `create_batches` with augmentations over 8 and 16 kHz sources, with the
  feature cache, and on 4 worker threads with 2 batches of prefetch, gives
  stt_tpu's batches (ids, labels and lengths exactly; features within
  FEATURE_TOL on full-band audio and BAND_LIMITED_TOL on band-limited
  audio, the port's torch frontend against stt_tpu's numpy one: the
  augmentations draw their parameters from the RNG, not from feature
  values) and the port's serial batches (features within the threaded
  tolerance of stt_tpu's own test, tests/test_data.py);
- a cache file written by either package is read by the other, and
  `maybe_invalidate` drops it at the same epochs;
- a consumer that stops early stops the pipeline, and an error in a
  worker reaches the consumer.

The sample augmentations seed their RNG with Python's hash of the sample id,
which differs between processes: both packages run in this one.
"""

import os
import random
import threading
import time

import numpy as np
import pytest

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.data import augmentations as jax_augmentations
from stt_tpu.data.feature_cache import FeatureCache as JaxFeatureCache
from stt_tpu.data.feeding import create_batches as jax_create_batches
from stt_tpu.data.sources import Sample as JaxSample
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.data import augmentations
from stt_tpu_torch.data.feature_cache import FeatureCache
from stt_tpu_torch.data.feeding import create_batches
from stt_tpu_torch.data.opus import opus_available
from stt_tpu_torch.data.sources import CSVWriter, Sample, SDBWriter
from stt_tpu_torch.frontend import FeatureConfig

FEATURE_TOL = 1e-4  # as tests/test_torch_trainer.py: the two frontends, MFCCs up to ~50
# Band-limited audio (8 kHz sources resampled to 16 kHz, the resample
# augmentation) leaves the upper mel bands nearly empty, where float32
# spectra carry a large relative error that the log brings out: there
# stt_tpu's own two frontends (jnp and numpy) differ by up to 3.7e-3 on the
# same audio, and the port's by as much from the numpy one.
BAND_LIMITED_TOL = 1e-2
LABELS = list(" abcdefgh")
SPECS = [
    "overlay[p=0.7,snr=10:20,layers=1:2]",
    "reverb[p=0.6,delay=10:30,decay=5:15]",
    "resample[p=0.5,rate=4000:8000]",
    "volume[p=0.8,dbfs=-25:-3]",
    "pitch[p=0.5,pitch=0.9:1.1~0.05]",
    "tempo[p=0.5,factor=0.85:1.15,max_time=-1]",
    "warp[p=0.5,num_t=2,num_f=2,warp_t=0.1,warp_f=0.05]",
    "frequency_mask[p=0.8,n=1:3,size=1:4]",
    "time_mask[p=0.8,n=1:2,size=10:60]",
    "time_mask[p=0.5,domain=signal,n=2,size=20]",
    "dropout[p=0.5,rate=0.02:0.08]",
    "dropout[p=0.3,domain=features,rate=0.05]",
    "add[p=0.5,stddev=0.05]",
    "add[p=0.3,domain=spectrogram,stddev=0.1]",
    "multiply[p=0.5,stddev=0.02]",
]
CODEC = "codec[p=0.5,bitrate=6000:16000]"


def utterance(rs, seconds, rate):
    t = np.arange(int(seconds * rate)) / rate
    audio = sum(rs.uniform(0.05, 0.2) * np.sin(2 * np.pi * rs.uniform(90, 400) * t)
                for _ in range(3)) + 0.02 * rs.randn(len(t))
    return np.clip(audio, -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two CSVs (16 and 8 kHz) of seeded utterances, a noise SDB for the
    overlay, and the alphabet."""
    root = tmp_path_factory.mktemp("augment")
    rs = np.random.RandomState(0)
    (root / "alphabet.txt").write_text("".join(label + "\n" for label in LABELS))
    paths = {"alphabet": str(root / "alphabet.txt"), "noise": str(root / "noise.sdb")}
    for name, rate, n in (("wide", 16000, 6), ("narrow", 8000, 5)):
        paths[name] = str(root / f"{name}.csv")
        with CSVWriter(paths[name]) as writer:
            for i in range(n):
                text = "".join(rs.choice(LABELS[1:], rs.randint(2, 6)))
                writer.add(Sample(f"{name}{i}", text, _audio=utterance(rs, rs.uniform(0.4, 1.1), rate),
                                  _rate=rate))
    with SDBWriter(paths["noise"]) as writer:
        for i in range(3):
            writer.add(Sample(f"n{i}", "noise", _audio=(0.1 * rs.randn(7000)).astype(np.float32),
                              _rate=16000))
    return paths


def specs(data, codec=False, overlay=True):
    """SPECS with the noise source; `overlay` False leaves the overlay out,
    for runs on worker threads: its noise cursor advances in the order rows
    are featurized, in both packages."""
    out = [s.replace("overlay[", f"overlay[source={data['noise']},") for s in SPECS
           if overlay or not s.startswith("overlay")]
    return out + ([CODEC] if codec and opus_available() else [])


def public(aug):
    return {k: v for k, v in vars(aug).items() if not k.startswith("_")}


def test_every_spec_parses_alike(data):
    for spec in specs(data, codec=True) + ["normalize_sample_rate[16000]", "volume",
                                           "time_mask", "reverb[delay=20.0~5]"]:
        got = augmentations.parse_augmentation(spec)
        want = jax_augmentations.parse_augmentation(spec)
        assert type(got).__name__ == type(want).__name__
        assert public(got) == public(want), spec
    for bad in ("volume[", "nope[p=1]", "Volume"):
        for module in (augmentations, jax_augmentations):
            with pytest.raises(ValueError):
                module.parse_augmentation(bad)
    assert augmentations.parse_augmentations(None) == []


@pytest.mark.parametrize("spec", SPECS + [CODEC, "normalize_sample_rate[8000]"])
@pytest.mark.parametrize("clock", [0.0, 0.37, 1.0])
def test_each_augmentation_equals_stt_tpu(data, spec, clock):
    if spec == CODEC and not opus_available():
        pytest.skip("libopus is not on this machine")
    spec = spec.replace("overlay[", f"overlay[source={data['noise']},")
    got_aug = augmentations.parse_augmentation(spec)
    want_aug = jax_augmentations.parse_augmentation(spec)
    rs = np.random.RandomState(len(spec))
    if isinstance(got_aug, augmentations.SampleAugmentation):
        audio = utterance(rs, 0.9, 16000)
        got, want = Sample("x", "ab", _audio=audio.copy()), JaxSample("x", "ab", _audio=audio.copy())
        got_aug.start(), want_aug.start()
        got_aug.apply(got, clock=clock, rng=random.Random(11))
        want_aug.apply(want, clock=clock, rng=random.Random(11))
        assert got.rate == want.rate
        np.testing.assert_array_equal(got.audio, want.audio)
        assert got.audio.dtype == want.audio.dtype
        return
    shape = {"signal": (9000,), "spectrogram": (47, 257), "features": (47, 26)}[got_aug.domain]
    tensor = np.abs(rs.randn(*shape)).astype(np.float32)
    got = got_aug.apply(tensor.copy(), clock=clock, rng=random.Random(12))
    want = want_aug.apply(tensor.copy(), clock=clock, rng=random.Random(12))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_apply_chains_equal_stt_tpu(data):
    got_augs = augmentations.parse_augmentations(specs(data, codec=True))
    want_augs = jax_augmentations.parse_augmentations(specs(data, codec=True))
    rs = np.random.RandomState(5)
    for i, clock in enumerate((0.0, 0.5, 0.99)):
        audio = utterance(rs, 1.0, 16000)
        got = augmentations.apply_sample_augmentations(
            Sample(f"s{i}", "a", _audio=audio.copy()), got_augs, clock=clock)
        want = jax_augmentations.apply_sample_augmentations(
            JaxSample(f"s{i}", "a", _audio=audio.copy()), want_augs, clock=clock)
        np.testing.assert_array_equal(got.audio, want.audio)
        for domain, tensor in (("signal", got.audio), ("spectrogram", np.abs(rs.randn(50, 257))),
                               ("features", rs.randn(50, 26))):
            np.testing.assert_array_equal(
                augmentations.apply_graph_augmentations(domain, tensor, got_augs, clock=clock),
                jax_augmentations.apply_graph_augmentations(domain, tensor, want_augs, clock=clock))


def batches_of(module_create, alphabet, fc, sources, **kw):
    return [(ids, [np.asarray(x, np.float32) for x in batch])
            for batch, ids in module_create(sources, alphabet, fc, **kw)]


def assert_same_batches(got, want, atol, rtol=0.0):
    assert [ids for ids, _ in got] == [ids for ids, _ in want]
    assert len(got) > 0
    for (_, (f, fl, l, ll)), (_, (jf, jfl, jl, jll)) in zip(got, want):
        np.testing.assert_array_equal(fl, jfl)
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_array_equal(ll, jll)
        assert f.shape == jf.shape
        np.testing.assert_allclose(f, jf, rtol=rtol, atol=atol)


@pytest.mark.parametrize("band_limited", [False, True])
@pytest.mark.parametrize("epoch", [0, 2])
def test_create_batches_with_augmentations_equals_stt_tpu(data, epoch, band_limited):
    """Training clocks of epoch 0 and 2 of 3: stt_tpu's batches. Full band:
    16 kHz sources and every augmentation but resample, features within
    FEATURE_TOL; band-limited: 8 kHz sources too (resampled to the
    frontend's rate) and every augmentation, within BAND_LIMITED_TOL."""
    kw = dict(batch_size=3, train_phase=True, epoch=epoch, total_epochs=3)
    sources = [data["wide"], data["narrow"]] if band_limited else [data["wide"]]
    chosen = [s for s in specs(data) if band_limited or not s.startswith("resample")]
    got = batches_of(create_batches, Alphabet(data["alphabet"]), FeatureConfig(), sources,
                     augmentations=augmentations.parse_augmentations(chosen), **kw)
    want = batches_of(jax_create_batches, JaxAlphabet(data["alphabet"]), JaxFeatureConfig(),
                      sources, augmentations=jax_augmentations.parse_augmentations(chosen), **kw)
    assert_same_batches(got, want, BAND_LIMITED_TOL if band_limited else FEATURE_TOL)


def test_threaded_batches_equal_serial_ones_and_stt_tpu(data):
    """4 workers and 2 batches of prefetch against the serial path, with every
    augmentation but the overlay (see `specs`): labels exactly, features to
    the tolerance of stt_tpu's own threaded test; and against stt_tpu's
    threaded batches."""
    no_overlay = specs(data, overlay=False)
    kw = dict(batch_size=4, train_phase=True, epoch=1, total_epochs=3)
    sources = [data["wide"], data["narrow"]]
    alphabet = Alphabet(data["alphabet"])
    runs = [batches_of(create_batches, alphabet, FeatureConfig(), sources,
                       augmentations=augmentations.parse_augmentations(no_overlay),
                       num_workers=w, prefetch=p, **kw) for w, p in ((0, 0), (4, 2), (1, 3))]
    for threaded in runs[1:]:
        assert_same_batches(threaded, runs[0], atol=1e-5, rtol=1e-4)
    want = batches_of(jax_create_batches, JaxAlphabet(data["alphabet"]), JaxFeatureConfig(),
                      sources, augmentations=jax_augmentations.parse_augmentations(no_overlay),
                      num_workers=4, prefetch=2, **kw)
    assert_same_batches(runs[1], want, BAND_LIMITED_TOL)


def test_feature_cache_fills_serves_and_is_read_by_stt_tpu(data, tmp_path):
    """Epoch 0 fills the cache and writes the file; epoch 1 decodes nothing
    and gives epoch 0's batches; stt_tpu's cache reads the port's file and
    gives its features and labels, and the port's reads stt_tpu's."""
    path, jax_path = str(tmp_path / "port.cache"), str(tmp_path / "jax.cache")
    cache = FeatureCache(path, cache_for_epochs=2)
    augs = augmentations.parse_augmentations(specs(data, overlay=False))
    kw = dict(batch_size=3, train_phase=True, augmentations=augs, total_epochs=3,
              num_workers=4, prefetch=2, feature_cache=cache, shuffle_batches=False)
    sources = [data["wide"], data["narrow"]]
    alphabet = Alphabet(data["alphabet"])
    first = batches_of(create_batches, alphabet, FeatureConfig(), sources, epoch=0, **kw)
    assert os.path.isfile(path) and cache.complete
    import stt_tpu_torch.data.feeding as feeding

    calls = []
    real = feeding.featurize_sample
    feeding.featurize_sample = lambda *a, **k: calls.append(a) or real(*a, **k)
    try:
        second = batches_of(create_batches, alphabet, FeatureConfig(), sources, epoch=1, **kw)
    finally:
        feeding.featurize_sample = real
    assert calls == [] and len(second) == len(first)
    assert_same_batches(second, first, atol=0)
    want = batches_of(jax_create_batches, JaxAlphabet(data["alphabet"]), JaxFeatureConfig(),
                      sources, epoch=0, feature_cache=JaxFeatureCache(jax_path, 2),
                      **{k: v for k, v in kw.items() if k not in ("augmentations", "feature_cache")},
                      augmentations=jax_augmentations.parse_augmentations(
                          specs(data, overlay=False)))
    assert_same_batches(first, want, BAND_LIMITED_TOL)
    for reader, writer_path in ((JaxFeatureCache(path), path), (FeatureCache(jax_path), jax_path)):
        other = FeatureCache(writer_path) if isinstance(reader, JaxFeatureCache) else \
            JaxFeatureCache(writer_path)
        assert reader.complete and other.complete
        for row in range(11):
            (f, l), (jf, jl) = reader.get(row), other.get(row)
            np.testing.assert_array_equal(f, jf)
            np.testing.assert_array_equal(l, jl)
        assert reader.get(11) is None


def test_cache_files_are_byte_equal_and_invalidate_alike(tmp_path):
    rs = np.random.RandomState(2)
    rows = [(rs.randn(rs.randint(1, 30), 26).astype(np.float32), rs.randint(0, 9, rs.randint(1, 6)))
            for _ in range(7)]
    caches = {}
    for name, cls in (("port", FeatureCache), ("jax", JaxFeatureCache)):
        cache = cls(str(tmp_path / f"{name}.cache"), cache_for_epochs=3)
        for row in rs.permutation(7) if name == "port" else range(7):
            cache.put(int(row), *rows[row])
        cache.finalize(7)
        caches[name] = cache
    assert (tmp_path / "port.cache").read_bytes() == (tmp_path / "jax.cache").read_bytes()
    for epoch in range(8):
        assert caches["port"].maybe_invalidate(epoch) == caches["jax"].maybe_invalidate(epoch)
        assert caches["port"].complete == caches["jax"].complete
    assert not (tmp_path / "port.cache").exists()
    ram, jax_ram = FeatureCache(""), JaxFeatureCache("")
    for cache in (ram, jax_ram):  # a partial fill serves from RAM and is not frozen
        cache.put(0, *rows[0])
        cache.finalize(2)
    assert ram.complete == jax_ram.complete is False
    np.testing.assert_array_equal(ram.get(0)[0], jax_ram.get(0)[0])


def test_cache_is_off_for_the_dummy_run_and_device_featurize(data, tmp_path):
    cache = FeatureCache(str(tmp_path / "c.cache"))
    alphabet = Alphabet(data["alphabet"])
    for kw in (dict(reverse=True, limit=4), dict(device_featurize=True)):
        list(create_batches([data["wide"]], alphabet, batch_size=2, feature_cache=cache, **kw))
        assert cache.get(0) is None and not cache.complete
    with pytest.raises(ValueError, match="device_featurize cannot apply"):
        list(create_batches([data["wide"]], alphabet, device_featurize=True, train_phase=True,
                            augmentations=augmentations.parse_augmentations(["frequency_mask"])))
    # sample- and signal-domain augmentations run before the card's frontend
    augs = ["volume[dbfs=-10]", "time_mask[domain=signal,n=1,size=20]"]
    kw = dict(batch_size=3, device_featurize=True, train_phase=True, epoch=1, total_epochs=2)
    got = batches_of(create_batches, alphabet, FeatureConfig(), [data["narrow"]],
                     augmentations=augmentations.parse_augmentations(augs), **kw)
    want = batches_of(jax_create_batches, JaxAlphabet(data["alphabet"]), JaxFeatureConfig(),
                      [data["narrow"]], augmentations=jax_augmentations.parse_augmentations(augs),
                      **kw)
    assert_same_batches(got, want, atol=0)


def test_abandoned_consumer_stops_the_pipeline(data):
    before = threading.active_count()
    gen = create_batches([data["wide"], data["narrow"]], Alphabet(data["alphabet"]),
                         batch_size=2, num_workers=3, prefetch=2)
    next(gen)
    start = time.perf_counter()
    gen.close()
    assert time.perf_counter() - start < 5.0
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_worker_errors_reach_the_consumer(data):
    bad = [Sample("bad", "§§", _audio=np.zeros(4000, np.float32), _rate=16000)]
    with pytest.raises(ValueError, match="Alphabet cannot encode"):
        list(create_batches(bad, Alphabet(data["alphabet"]), batch_size=1, num_workers=2,
                            prefetch=2))
    unreadable = [Sample("gone", "ab", loader=lambda: open("/nonexistent"))]
    with pytest.raises(FileNotFoundError):
        list(create_batches(unreadable, Alphabet(data["alphabet"]), batch_size=1, num_workers=2,
                            prefetch=1, shuffle_batches=False))
