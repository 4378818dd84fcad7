"""The port's dataset sources against stt_tpu's: SDB sample databases (WAV-
and Opus-coded) and webdataset tars written by one package and read by the
other give the same samples, and the port's SDBWriter writes stt_tpu's
bytes; CSVs of FLAC, SPHERE and 8 kHz WAV files read as stt_tpu reads them;
several sources merge alike. Then the small host modules that came with
them: `data.helpers` (value ranges), `data.stm` and `data.auto_input`.
Samples, bytes and files must be equal. Every file is made here from a
seed.
"""

import csv
import io
import os
import random
import sys
import tarfile
import wave

import numpy as np
import pytest

import stt_tpu.data.sources as jax_sources
from stt_tpu.data import auto_input as jax_auto_input
from stt_tpu.data import helpers as jax_helpers
from stt_tpu.data import stm as jax_stm
import stt_tpu_torch.data.sources as sources
from stt_tpu_torch.data import auto_input, helpers, stm
from stt_tpu_torch.data.audio import write_wav
from stt_tpu_torch.data.opus import opus_available
from stt_tpu_torch.data.sph import write_sph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import write_flac  # noqa: E402

WORDS = ["she", "had", "your", "dark", "suit", "in", "greasy", "wash", "water"]


def samples(n: int, rate: int, seed: int, module=sources):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = np.arange(int(rs.uniform(0.3, 0.9) * rate)) / rate
        audio = (0.2 * np.sin(2 * np.pi * rs.uniform(100, 500) * t)
                 + 0.01 * rs.randn(len(t))).astype(np.float32)
        text = " ".join(rs.choice(WORDS, rs.randint(1, 4)))
        out.append(module.Sample(f"s{i}", text, _audio=audio, _rate=rate))
    return out


def assert_same_samples(got, want, ids=True):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.transcript, a.rate, a.duration_hint) == (b.transcript, b.rate, b.duration_hint)
        if ids:
            assert a.sample_id == b.sample_id
        np.testing.assert_array_equal(a.audio, b.audio)
        assert a.audio.dtype == b.audio.dtype


@pytest.mark.parametrize("labeled", [True, False])
@pytest.mark.parametrize("rate", [8000, 16000])
def test_sdb_written_by_either_package_reads_alike_and_is_byte_equal(tmp_path, labeled, rate):
    paths = {}
    for name, module in (("port", sources), ("jax", jax_sources)):
        paths[name] = str(tmp_path / f"{name}.sdb")
        with module.SDBWriter(paths[name], labeled=labeled) as writer:
            for sample in samples(5, rate, seed=rate, module=module):
                writer.add(sample)
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    for path in paths.values():
        got, want = sources.SDBSource(path), jax_sources.SDBSource(path)
        assert (len(got), got.labeled, got.audio_mime) == (len(want), want.labeled, want.audio_mime)
        assert_same_samples(got, want)
        assert_same_samples(sources.samples_from_sources([path]),
                            jax_sources.samples_from_sources([path]))
        assert got[3].sample_id == f"{path}:3" and got[3].rate == rate
        got.close()
        want.close()


def test_opus_sdb_round_trips_between_the_packages(tmp_path):
    if not opus_available():
        pytest.skip("libopus is not on this machine")
    paths = {}
    for name, module in (("port", sources), ("jax", jax_sources)):
        paths[name] = str(tmp_path / f"{name}.sdb")
        with module.SDBWriter(paths[name], audio_type="opus", bitrate=16000) as writer:
            for sample in samples(3, 16000, seed=2, module=module):
                writer.add(sample)
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    assert_same_samples(sources.SDBSource(paths["jax"]), jax_sources.SDBSource(paths["port"]),
                        ids=False)


def test_sdb_refuses_what_stt_tpu_refuses(tmp_path):
    bad = str(tmp_path / "bad.sdb")
    with open(bad, "wb") as f:
        f.write(b"NOTANSDB" + bytes(32))
    for module in (sources, jax_sources):
        with pytest.raises(ValueError, match="not an SDB file"):
            module.SDBSource(bad)
        with pytest.raises(ValueError, match="unsupported SDB audio_type"):
            module.SDBWriter(str(tmp_path / "x.sdb"), audio_type="mp3")
    unlabeled = str(tmp_path / "u.sdb")
    with sources.SDBWriter(unlabeled, labeled=False) as writer:
        writer.add(samples(1, 16000, 0)[0])
    for module in (sources, jax_sources):
        with pytest.raises(ValueError, match="has no transcripts"):
            module.SDBSource(unlabeled, labeled=True)


def write_tar(path: str, items, with_text=True):
    """A webdataset tar: key.wav and key.txt per sample, and a stray file."""
    with tarfile.open(path, "w") as tar:
        def add(name, data):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        for key_, sample in items:
            buf = io.BytesIO()
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sample.rate)
                w.writeframes(np.clip(sample.audio * 32768, -32768, 32767).astype(np.int16).tobytes())
            add(f"{key_}.wav", buf.getvalue())
            if with_text:
                add(f"{key_}.txt", (sample.transcript + "\n").encode())
        add("README", b"not a sample")


@pytest.mark.parametrize("with_text", [True, False])
def test_tar_reads_as_stt_tpu_reads_it(tmp_path, with_text):
    path = str(tmp_path / "data.tar")
    items = [(f"part/{k:03d}", s) for k, s in zip((5, 1, 3, 2), samples(4, 8000, seed=4))]
    write_tar(path, items, with_text)
    got, want = sources.TarSource(path), jax_sources.TarSource(path)
    assert got.labeled == want.labeled == with_text
    assert [k for k, _, _ in got.items] == [k for k, _, _ in want.items] == sorted(k for k, _ in items)
    assert_same_samples(got, want)
    assert_same_samples(sources.samples_from_sources([path]),
                        jax_sources.samples_from_sources([path]))


def test_csv_of_flac_sph_and_8khz_wav_and_merged_sources(tmp_path):
    """A CSV names FLAC, SPHERE (mu-law, 8 kHz) and WAV files; every row reads
    by its extension as stt_tpu's CSVSource reads it, and merging it with an
    SDB and a tar interleaves alike."""
    rows = []
    for i in range(6):
        sample = samples(1, 8000 if i % 2 else 16000, seed=i)[0]
        ext = ("flac", "sph", "wav")[i % 3]
        path = tmp_path / f"a{i}.{ext}"
        if ext == "flac":
            write_flac(str(path), sample.audio, sample.rate, order=i % 5)
        elif ext == "sph":
            write_sph(str(path), sample.audio, sample.rate, coding="ulaw")
        else:
            write_wav(str(path), sample.audio, sample.rate)
        rows.append([path.name, os.path.getsize(path), sample.transcript])
    csv_path = str(tmp_path / "mixed.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["wav_filename", "wav_filesize", "transcript"])
        writer.writerows(rows)
    assert_same_samples(sources.CSVSource(csv_path), jax_sources.CSVSource(csv_path))
    sdb = str(tmp_path / "b.sdb")
    with sources.SDBWriter(sdb) as writer:
        for sample in samples(3, 8000, seed=9):
            writer.add(sample)
    tar = str(tmp_path / "c.tar")
    write_tar(tar, [(f"k{i}", s) for i, s in enumerate(samples(3, 16000, seed=10))])
    paths = [csv_path, sdb, tar]
    assert_same_samples(sources.samples_from_sources(paths),
                        jax_sources.samples_from_sources(paths))


def test_value_ranges_pick_alike():
    for spec in ("1.5", "0.8:1.2~0.1", "3~1", "2:6", (1.0, 2.0, 0.5), 7, "-3:0"):
        for kind in ("int_range", "float_range"):
            try:
                want = getattr(jax_helpers, kind)(spec)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(helpers, kind)(spec)
                continue
            got = getattr(helpers, kind)(spec)
            assert tuple(got) == tuple(want)
            for clock in (None, 0.0, 0.25, 1.0, 3.0):
                a, b = random.Random(5), random.Random(5)
                assert (helpers.pick_value_from_range(got, clock, a)
                        == jax_helpers.pick_value_from_range(want, clock, b))


def test_stm_and_auto_input_equal_stt_tpu(tmp_path):
    stm_path = tmp_path / "talk.stm"
    stm_path.write_text(
        ";; comment\n"
        "talk 1 spk1 0.00 1.50 <o,f0,male> she had <unk> your\n"
        "talk 1 spk2 1.50 2.25 <o,f0,female> ignore_time_segment_in_scoring\n"
        "talk 1 spk1 2.25 4.00 <o,f0,male> dark suit\n\n")
    got, want = stm.parse_stm_file(str(stm_path)), jax_stm.parse_stm_file(str(stm_path))
    assert [vars(s) for s in got] == [vars(s) for s in want] and len(got) == 2
    rs = np.random.RandomState(3)
    big = tmp_path / "all.csv"
    with open(big, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["wav_filename", "wav_filesize", "transcript"])
        for i in range(40):
            writer.writerow([f"f{i}.wav", 1000 + i, " ".join(rs.choice(WORDS, 3))])
    outputs = {}
    for name, module in (("port", auto_input), ("jax", jax_auto_input)):
        splits = module.create_datasets_from_auto_input(str(big), str(tmp_path / name))
        alphabet = module.create_alphabet_from_sources(list(splits), str(tmp_path / f"{name}.txt"))
        outputs[name] = [open(p, "rb").read() for p in (*splits, alphabet)]
    assert outputs["port"] == outputs["jax"]
    assert auto_input._required_sample_size(10_000) == jax_auto_input._required_sample_size(10_000)
