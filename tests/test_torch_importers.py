"""The port's corpus importers (`stt_tpu_torch.tools.import_*`,
`importers`, `ldc_conversational`) against stt_tpu's on the CPU:

- code: each port module holds stt_tpu's code apart from docstrings and
  the package its imports name;
- behaviour: each importer's `main(argv)` runs on a corpus written here
  in that corpus's published layout (the layouts of
  tests/test_importers_corpora.py; archives where the importer takes
  one), once for each package on its own copy of the same bytes. The CSVs
  must be equal row for row with paths taken relative to the copy, every
  file the import writes (WAVs, extracted archives) byte-equal, and what
  it prints equal. Both packages run the same numpy code, so the
  tolerance is 0. `ldc_conversational`'s three steps are held the same way;
- the slice: a LibriSpeech corpus of 4 utterances imported by each
  package, its CSV batched by each package's `create_batches` (labels
  equal, features within FEATURE_TOL), and one f32 train step from the
  same parameters against stt_tpu's (the tolerances of
  tests/test_torch_train_step.py).

FLAC is written by chip_smoke.py's encoder, Opus through the system libopus
(the MLS case skips where it is absent, as the codec tests do), SPHERE by
`write_sph`; MP3 clips are stand-in bytes with a WAV beside them, as in
stt_tpu's own importer tests.
"""

import csv
import gzip
import importlib
import json
import os
import shutil
import sys
import tarfile
import zipfile
from pathlib import Path

import numpy as np
import pytest

import jax

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.data.feeding import create_batches as jax_create_batches
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import init_params
from stt_tpu.train import create_train_state as jax_create_train_state
from stt_tpu.train import make_train_step as jax_make_train_step
from stt_tpu.train.step import _loss_fn as jax_loss_fn
from stt_tpu.train.step import create_optimizer as jax_create_optimizer
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.artifact import params_from_numpy
from stt_tpu_torch.data.audio import read_audio, write_wav
from stt_tpu_torch.data.feeding import create_batches
from stt_tpu_torch.data.sph import write_sph
from stt_tpu_torch.frontend import FeatureConfig
from stt_tpu_torch.models import ModelConfig
from stt_tpu_torch.train import create_train_state, make_train_step
from test_torch_audio_formats import write_ogg_opus
from test_torch_scorer import ROOT, code_of
from test_torch_train_step import LR, TOL, flat, jax_batch, rel_norm

sys.path.insert(0, ROOT)
from chip_smoke import utterance, write_flac  # noqa: E402

IMPORTERS = sorted(name[len("import_"):-3] for name in os.listdir(os.path.join(ROOT, "stt_tpu", "tools"))
                   if name.startswith("import_"))
MODULES = ["importers", "ldc_conversational", *(f"import_{name}" for name in IMPORTERS)]
PACKAGES = ("stt_tpu", "stt_tpu_torch")
FEATURE_TOL = 1e-4  # tests/test_torch_trainer.py's, float32 MFCC
RATE = 16000


def test_the_port_has_every_importer():
    assert len(IMPORTERS) == 26
    ported = {n[:-3] for n in os.listdir(os.path.join(ROOT, "stt_tpu_torch", "tools"))}
    assert set(MODULES) <= ported


@pytest.mark.parametrize("module", MODULES)
def test_importer_module_holds_the_same_code(module):
    assert code_of(os.path.join(ROOT, "stt_tpu_torch", "tools", f"{module}.py"), "stt_tpu_torch") \
        == code_of(os.path.join(ROOT, "stt_tpu", "tools", f"{module}.py"), "stt_tpu")


# ---- corpora in their published layouts -------------------------------------


def wav(path: Path, seconds: float, rng, rate: int = RATE) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(str(path), utterance(seconds, rate, rng), rate)


def sph(path: Path, seconds: float, rng, rate: int = RATE, channels: int = 1,
        coding: str = "pcm") -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    audio = utterance(seconds, rate, rng)
    if channels == 2:
        audio = np.stack([audio, utterance(seconds, rate, rng)], axis=-1)
    write_sph(str(path), audio, rate, coding=coding)


def text(path: Path, body: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(body, encoding="utf-8")


def tar_gz(archive: Path, members) -> None:
    """A gzipped tar of (path, name in the archive) pairs, its bytes fixed by
    its contents (no time stamps or owners), so that both copies of a corpus
    hold the same archive."""
    def same(info: tarfile.TarInfo) -> tarfile.TarInfo:
        info.mtime, info.uid, info.gid, info.uname, info.gname = 0, 0, 0, "", ""
        return info

    with gzip.GzipFile(archive, "wb", mtime=0) as f, tarfile.open(fileobj=f, mode="w") as tar:
        for path, name in members:
            tar.add(path, name, filter=same)


def pack(tree: Path, archive: Path) -> None:
    """`tree` as a gzipped tar (or a zip) at `archive`, its members named
    relative to tree's parent; the tree itself is removed."""
    if archive.suffix == ".zip":
        with zipfile.ZipFile(archive, "w") as z:
            for path in sorted(tree.rglob("*")):
                z.write(path, path.relative_to(tree.parent))
    else:
        tar_gz(archive, [(tree, tree.name)])
    shutil.rmtree(tree)


def locale(root: Path) -> str:
    """A --validate_label_locale plug-in that keeps every non-empty label."""
    path = root / "keep_labels.py"
    path.write_text("def validate_label(label):\n    return label.strip().lower() or None\n")
    return str(path)


def corpus_aidatatang(root, rng):
    main = root / "aidatatang_200zh"
    lines = []
    for subset, n in (("train", 3), ("dev", 1), ("test", 1)):
        group = main / "corpus" / subset / "G0002"
        for i in range(n):
            utt = f"T0055G0002S{subset[:2]}{i:02d}"
            wav(group / f"{utt}.wav", 11.0 if subset == "train" and i == 0 else 2.0, rng)
            lines.append(f"{utt} 你好 世界 {i}\n")
        pack(group, group.parent / "G0002.tar.gz")
    text(main / "transcript" / "aidatatang_200_zh_transcript.txt", "".join(lines))
    pack(main, root / "aidatatang_200zh.tgz")
    return [str(root / "aidatatang_200zh.tgz"), "--target_dir", str(root)]


def corpus_aishell(root, rng):
    main = root / "data_aishell"
    lines = []
    for subset, n in (("train", 3), ("dev", 2), ("test", 2)):
        for i in range(n):
            utt = f"BAC009S0002W0{subset[:2]}{i}"
            wav(main / "stage" / subset / "S0002" / f"{utt}.wav",
                12.0 if subset == "train" and i == 0 else 2.0, rng)
            lines.append(f"{utt} 今天 天气 {i}\n")
    (main / "wav").mkdir()
    tar_gz(main / "wav" / "S0002.tar.gz",
           [(main / "stage" / subset, subset) for subset in ("train", "dev", "test")])
    shutil.rmtree(main / "stage")
    text(main / "transcript" / "aishell_transcript_v0.8.txt", "".join(lines))
    pack(main, root / "data_aishell.tgz")
    return [str(root / "data_aishell.tgz"), "--target_dir", str(root)]


def corpus_atthack(root, rng):
    for i in range(10):
        name = f"F01_a{i % 3}_s{i:03d}"
        wav(root / "wav" / f"{name}.wav", 2.0 + 0.1 * i, rng)
        text(root / "txt" / f"{name}.txt", "Je vous remercie" if i != 4 else " ")
    return [str(root), "--validate_label_locale", locale(root)]


def corpus_ccpmf(root, rng):
    data = root / "sessions"
    wav(data / "session1.wav", 20.0, rng)
    text(data / "session1.xml",
         '<data><row timestamp="0.2" timedur="2.0">bonjour à tous </row>'
         '<row timestamp="2.4" timedur="2.0">et bienvenue</row>'
         '<row timestamp="8.0" timedur="0.4">oui</row>'
         '<row timestamp="14.0" timedur="3.0">le budget est de 200 euros</row></data>')
    return [str(data), "--target_dir", str(root / "out")]


def corpus_cv(root, rng):
    extracted = root / "cv_corpus_v1"
    rows = ["filename,text,up_votes,down_votes,age,gender,accent,duration"]
    for split in ("cv-valid-dev", "cv-valid-train"):
        for i in range(3):
            stem = f"sample-{i:06d}"
            (extracted / split).mkdir(parents=True, exist_ok=True)
            (extracted / split / f"{stem}.mp3").write_bytes(b"\xff\xfbnot mp3")
            if i < 2:  # the third clip has no decoded WAV and fails
                wav(extracted / split / f"{stem}.wav", 2.0 + i, rng)
            rows.append(f"{split}/{stem}.mp3,Hello common voice {'ünï' if i else ''},1,0,,,,")
        text(extracted / f"{split}.csv", "\n".join(rows))
        rows = rows[:1]
    return [str(root), "--normalize"]


def corpus_cv2(root, rng):
    clips = root / "cv" / "clips"
    for split, n in (("train", 4), ("dev", 2)):
        lines = ["client_id\tpath\tsentence\tup_votes"]
        for i in range(n):
            name = f"common_voice_{split}_{i}.wav"
            wav(clips / name, 1.5 + 0.5 * i, rng)
            lines.append(f"c{i}\t{name}\t{'Hello there!' if i != 1 else 'Num83r5 drop'}\t2")
        lines.append(f"c9\tmissing_{split}.wav\tgone\t0")
        text(root / "cv" / f"{split}.tsv", "\n".join(lines) + "\n")
    return ["--audio_dir", str(clips), "--tsv_dir", str(root / "cv"),
            "--target_dir", str(root / "out"), "--workers", "2"]


def corpus_cv_personal(root, rng):
    audio = root / "clips"
    lines = ["original_sentence_id\tsentence\tlocale"]
    for i in range(3):
        sid = f"sent{i}"
        text(audio / f"{sid}.mp3", "not mp3")
        if i < 2:
            wav(audio / f"{sid}.wav", 2.5, rng)
        lines.append(f"{sid}\tHello there friend {i if i == 1 else ''}\ten")
    text(root / "sentences.tsv", "\n".join(lines))
    return [str(root / "sentences.tsv"), "--audio_dir", str(audio),
            "--space_after_every_character"]


def corpus_fisher(root, rng):
    for call in ("00001", "00002"):
        sph(root / "fisher_audio" / f"fe_03_{call}.sph", 8.0, rng, rate=8000, channels=2,
            coding="ulaw")
        text(root / "trans" / f"fe_03_{call}.txt",
             "# header\n\n0.50 2.50 A: hello how are you\n"
             "3.00 5.00 B: i am [laughter] fine thanks\n5.50 7.50 A: (( )) [noise]\n")
    return [str(root)]


def corpus_freestmandarin(root, rng):
    main = root / "ST-CMDS-20170001_1-OS"
    for i in range(10):
        wav(main / f"20170001P{i:05d}.wav", 11.0 if i == 3 else 1.0 + 0.1 * i, rng)
        text(main / f"20170001P{i:05d}.txt", f"句子{i}")
    pack(main, root / "ST-CMDS-20170001_1-OS.tar.gz")
    return [str(root / "ST-CMDS-20170001_1-OS.tar.gz")]


def corpus_gram_vaani(root, rng):
    lines = ['"id","audio_url","labelled","transcript","labels","file","len","user"']
    for i in range(6):
        name = f"clip{i}.mp3"
        if i != 5:
            wav(root / "out" / f"clip{i}.wav", 2.0 + 0.3 * i, rng)
        lines.append(f'"{i}","http://x/{name}?v=1","y","नमस्ते दुनिया{' 2' if i == 2 else ''}","l","{name}","3","u"')
    text(root / "catalog.csv", "\n".join(lines))
    return ["--csv_filename", str(root / "catalog.csv"), "--target_dir", str(root / "out")]


def corpus_ldc93s1(root, rng):
    src = root / "smoke_test"
    wav(src / "LDC93S1.wav", 2.92, rng)
    text(src / "LDC93S1.txt", "0 46797 She had your dark suit in greasy wash water all year.\n")
    return [str(root / "out"), "--source_dir", str(src)]


def corpus_librivox(root, rng):
    for name, n in (("dev-clean", 3), ("test-other", 2)):
        chapter = root / "stage" / "LibriSpeech" / name / "84" / "121123"
        chapter.mkdir(parents=True)
        lines = []
        for i in range(n):
            seqid = f"84-121123-{i:04d}"
            write_flac(str(chapter / f"{seqid}.flac"), utterance(1.5 + 0.5 * i, RATE, rng), RATE)
            lines.append(f"{seqid} GO DO YOU HEAR Café {i}\n")
        lines.append("84-121123-0099 A LINE WITHOUT AUDIO\n")
        text(chapter / "84-121123.trans.txt", "".join(lines))
        if name == "test-other":  # this set comes as its archive
            tar_gz(root / f"{name}.tar.gz",
                   [(root / "stage" / "LibriSpeech" / name, f"LibriSpeech/{name}")])
            shutil.rmtree(root / "stage" / "LibriSpeech" / name)
    shutil.move(str(root / "stage" / "LibriSpeech"), str(root / "LibriSpeech"))
    shutil.rmtree(root / "stage")
    return [str(root), "--sets", "dev-clean,test-other,train-clean-100", "--base_url", "",
            "--relative"]


def corpus_lingua_libre(root, rng):
    spk = root / "Q21-fra-French" / "speaker1"
    for stem in ("bonjour tout le monde", "Q12345", "encore une phrase", "sans wav", "ok"):
        text(spk / f"{stem}.ogg", "OggS stand-in")
        if stem != "sans wav":
            wav(spk / f"{stem}.wav", 0.1 if stem == "ok" else 2.0, rng)
    return [str(root / "Q21-fra-French"), "--bogus-records", "^Q[0-9]+",
            "--validate_label_locale", locale(root)]


def corpus_m_ailabs(root, rng):
    for book in ("book1", "book2"):
        folder = root / "en_US" / "by_book" / "female" / "spk" / book
        lines = []
        for i in range(6):
            name = f"{book}_{i:03d}"
            wav(folder / "wavs" / f"{name}.wav", 2.0 + 0.2 * i, rng)
            lines.append(f"{name}|Raw text.|Clean text variant number {chr(97 + i)}\n")
        text(folder / "metadata.csv", "".join(lines))
    return [str(root / "en_US"), "--skiplist", "book2"]


def corpus_magicdata(root, rng):
    archives = root / "archives"
    archives.mkdir(parents=True)
    for subset in ("train", "dev", "test"):
        rows = ["UtteranceID\tSpeakerID\tTranscription"]
        for i in range(3):
            name = f"{subset}_{i}.wav"
            wav(root / subset / "S01" / name, 11.0 if subset == "train" and i == 2 else 2.0, rng)
            rows.append(f"{name}\tS01\t{'[FIL] 嗯' if subset == 'train' and i == 0 else '好的'}")
        text(root / subset / "TRANS.txt", "\n".join(rows))
        pack(root / subset, archives / f"magicdata_{subset}_set.tar.gz")
    return [str(archives), "--target_dir", str(root / "magicdata")]


def corpus_mls(root, rng):
    for split in ("dev", "test"):
        audio = root / "mls_english" / split / "audio" / "9" / "12"
        audio.mkdir(parents=True)
        write_flac(str(audio / "9_12_000001.flac"), utterance(2.0, RATE, rng), RATE)
        write_ogg_opus(str(audio / "9_12_000002.opus"), utterance(1.5, 48000, rng))
        text(root / "mls_english" / split / "transcripts.txt",
             "9_12_000001\tfirst utterance text\n9_12_000002\tsecond utterance text\n"
             "9_12_000003\tno audio\n")
    return [str(root / "mls_english"), "--language", "english"]


def corpus_primewords(root, rng):
    main = root / "primewords_md_2018_set1"
    entries = []
    for i in range(6):
        name = f"a{i}.wav"
        wav(main / "audio_files" / "0" / f"0{i % 2}" / name, 1.0 + 0.2 * i, rng)
        entries.append({"file": name, "text": f"文本 {i}"})
    entries.append({"file": "gone.wav", "text": "x"})
    text(main / "set1_transcript.json", json.dumps(entries))
    pack(main, root / "primewords_md_2018_set1.tar.gz")
    return [str(root / "primewords_md_2018_set1.tar.gz"), "--target_dir", str(root)]


def corpus_slr57(root, rng):
    corpus = root / "African_Accented_French"
    lines = []
    for i in range(6):
        name = f"caf_{i:04d}"
        wav(corpus / "speech" / "test" / f"{name}.wav", 2.0 + 0.2 * i, rng)
        lines.append(f"{name} bonjour le monde encore {i if i == 2 else ''}\n")
    text(corpus / "transcripts" / "test" / "ca16" / "prompts.txt", "".join(lines))
    return [str(root)]


def corpus_swb(root, rng):
    sph(root / "swb1_d1" / "data" / "sw02001.sph", 8.0, rng, rate=8000, channels=2,
        coding="ulaw")
    trans = root / "swb_ms98_transcriptions" / "20" / "2001"
    text(trans / "sw2001A-ms98-a-trans.text",
         "sw2001A-ms98-a-0001 0.50 2.50 yeah [silence] i think so\n"
         "sw2001A-ms98-a-0002 3.00 4.00 [noise]\n"
         "sw2001A-ms98-a-0003 4.20 6.00 uh-huh [laughter-right] exactly\n")
    text(trans / "sw2001B-ms98-a-trans.text", "sw2001B-ms98-a-0001 4.50 6.50 right exactly\n")
    text(root / "swb_ms98_transcriptions" / "20" / "2002" / "sw2002A-ms98-a-trans.text",
         "sw2002A-ms98-a-0001 0.10 1.00 no audio for this call\n")
    return [str(root)]


def corpus_swc(root, rng):
    for article, offset in (("article1", 0), ("article2", 700)):
        folder = root / "english" / article
        wav(folder / "audio.wav", 8.0, rng)
        text(folder / "aligned.swc", f"""<article>
        <meta><prop key="reader.name" value="reader{offset}"/></meta>
        <d><s>
          <t text="Hello"><n start="{500 + offset}" end="1200" pronunciation="hello"/></t>
          <t text="spoken"><n start="1300" end="2100" pronunciation="spoken"/></t>
          <t text="wikipedia"><n start="2200" end="3400" pronunciation="wikipedia"/></t>
        </s>
        <s>
          <t text="another"><n start="4000" end="4900" pronunciation="another"/></t>
          <t text="sentence"><n start="5000" end="6200" pronunciation="sentence"/></t>
          <t text="42"/>
        </s></d>
        </article>""")
    return [str(root / "english"), "--language", "english", "--max_duration", "5000"]


def corpus_ted(root, rng):
    rel = root / "TEDLIUM_release2"
    for subset in ("train", "dev", "test"):
        (rel / subset / "stm").mkdir(parents=True)
        (rel / subset / "sph").mkdir(parents=True)
    sph(rel / "dev" / "sph" / "TalkA.sph", 10.0, rng)
    text(rel / "dev" / "stm" / "TalkA.stm",
         "TalkA 1 spk 1.00 3.50 <o,f0,male> hello there world\n"
         "TalkA 1 spk 4.00 6.00 <o,f0,male> ignore_time_segment_in_scoring\n"
         "TalkA 1 spk 6.50 9.00 <o,f0,male> second segment text\n")
    sph(rel / "test" / "sph" / "TalkB.sph", 5.0, rng)
    text(rel / "test" / "stm" / "TalkB.stm", "TalkB 1 spk 0.50 4.00 <o,f0,female> a third one\n")
    pack(rel, root / "TEDLIUM_release2.tar.gz")
    return [str(root)]


def corpus_timit(root, rng):
    for subset, spk, utt in (("TRAIN", "DR1/FCJF0", "SI1027"), ("TRAIN", "DR1/FCJF0", "SA1"),
                             ("TRAIN", "DR1/MDAB0", "SX109"), ("TEST", "DR2/MABW0", "SX134")):
        folder = root / "TIMIT" / subset / spk
        sph(folder / f"{utt}.WAV", 2.0, rng)
        text(folder / f"{utt}.TXT", f"0 32000 She said: Hello, world-{utt}!\n")
    return [str(root)]


def corpus_ts(root, rng):
    lines = ["path,text"]
    for i in range(6):
        wav(root / "audio" / f"s{i}.wav", 2.0 + 0.2 * i, rng)
        lines.append(f'audio/s{i}.wav,"Voilà — l’énoncé numéro {i}!"')
    text(root / "data.csv", "\n".join(lines))
    return [str(root), "--english_compatible"]


def corpus_tuda(root, rng):
    extracted = root / "german-speechdata-package-v2"
    for subset in ("train", "dev", "test"):
        for rec, sentence in (("rec1", "Schöne Grüße aus Köln"), ("rec2", "Nummer 42 €")):
            text(extracted / subset / f"{rec}.xml",
                 f"<recording><cleaned_sentence>{sentence}</cleaned_sentence></recording>")
            for mic in ("Kinect-Beam", "Realtek"):
                wav(extracted / subset / f"{rec}_{mic}.wav", 2.5, rng)
    pack(extracted, root / "german-speechdata-package-v2.tar.gz")
    return ["--base_dir", str(root), "--max_duration", "10"]


def corpus_vctk(root, rng):
    corpus = root / "VCTK-Corpus"
    for i in range(5):
        utt = f"p225_{i:03d}"
        path = corpus / "wav48" / "p225" / f"{utt}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        silence = np.zeros(12000, np.float32)
        write_wav(str(path), np.concatenate([silence, utterance(2.0, 48000, rng), silence]), 48000)
        text(corpus / "txt" / "p225" / f"{utt}.txt", "Please call Stella." if i != 3 else "[x]")
    pack(corpus, root / "VCTK-Corpus.zip")
    return [str(root)]


def corpus_voxforge(root, rng):
    for i in range(5):
        session = root / f"spk{i}-20240{i}"
        text(session / "etc" / "PROMPTS", f"spk{i}/mfc/u{i} HELLO WORLD NUMBER {chr(97 + i)}\n")
        wav(session / "wav" / f"u{i}.wav", 2.0, rng)
    return [str(root), "--number_of_test", "1", "--number_of_dev", "1"]


CORPORA = {name: globals()[f"corpus_{name}"] for name in IMPORTERS}


def files_under(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in root.rglob("*") if p.is_file()}


def imported(package: str, name: str, root: Path, seed: int, capsys) -> tuple:
    """Write the corpus of `name` under root from `seed`, run the package's
    importer on it, and return (its CSVs' rows and every other file it
    wrote, by path relative to root; what it printed), with root in them
    written as ROOT."""
    argv = CORPORA[name](root, np.random.RandomState(seed))
    before = set(files_under(root))
    capsys.readouterr()
    importlib.import_module(f"{package}.tools.import_{name}").main(argv)
    printed = capsys.readouterr().out.replace(str(root), "ROOT")
    written = {}
    for rel, path in sorted(files_under(root).items()):
        if rel in before or "__pycache__" in rel:
            continue
        if rel.endswith(".csv"):
            with open(path, newline="", encoding="utf-8") as f:
                written[rel] = [[cell.replace(str(root), "ROOT") for cell in row]
                                for row in csv.reader(f)]
        else:
            written[rel] = path.read_bytes()
    return written, printed


@pytest.mark.parametrize("name", IMPORTERS)
def test_importer_writes_what_stt_tpu_writes(name, tmp_path, capsys):
    seed = IMPORTERS.index(name)
    (jax_files, jax_out), (port_files, port_out) = (
        imported(package, name, tmp_path / package, seed, capsys) for package in PACKAGES)
    assert sorted(port_files) == sorted(jax_files)
    for rel, want in jax_files.items():
        assert port_files[rel] == want, rel
    assert port_out == jax_out
    csvs = {rel: rows for rel, rows in port_files.items() if rel.endswith(".csv")}
    assert csvs and all(rows[0] == ["wav_filename", "wav_filesize", "transcript"]
                        for rows in csvs.values())
    assert sum(len(rows) - 1 for rows in csvs.values()), f"{name} imported no sample"
    root = tmp_path / "stt_tpu_torch"
    for rel, rows in csvs.items():  # every row names a file that reads as 16 kHz mono
        for path, size, _ in rows[1:]:
            path = os.path.join((root / rel).parent, path.replace("ROOT", str(root)))
            assert os.path.getsize(path) == int(size)
            audio, rate = read_audio(path)
            assert rate == RATE and audio.ndim == 1 and len(audio)


def test_ldc_conversational_does_what_stt_tpu_does(tmp_path):
    """clean_conversational on annotated lines, convert_call_channels on a
    two-channel 8 kHz mu-law call, slice_segments on one channel."""
    lines = ["yeah [silence] i think so", "[noise]", "uh-huh <b_aside> {laugh} exact-",
             "Café / naïve", "the 2nd one", "i am [laughter-fine] ok"]
    out = {}
    for package in PACKAGES:
        module = importlib.import_module(f"{package}.tools.ldc_conversational")
        root = tmp_path / package
        sph(root / "sw02001.sph", 6.0, np.random.RandomState(3), rate=8000, channels=2,
            coding="ulaw")
        channels = module.convert_call_channels(str(root / "sw02001.sph"), str(root / "wav"))
        again = module.convert_call_channels(str(root / "sw02001.sph"), str(root / "wav"))
        rows = module.slice_segments(channels[1], [(0.5, 2.0, "right exactly"),
                                                   (2.5, 2.5, "empty"), (3.0, 5.5, "and more")],
                                     str(root / "split"), "sw2001B")
        out[package] = ([module.clean_conversational(line) for line in lines],
                        [os.path.relpath(p, root) for p in channels + again],
                        [(os.path.relpath(r[0], root), *r[1:]) for r in rows],
                        {rel: p.read_bytes() for rel, p in files_under(root).items()})
    assert out["stt_tpu_torch"] == out["stt_tpu"]
    assert len(out["stt_tpu"][2]) >= 2


# ---- the slice: import, batch and one train step ----------------------------


def test_imported_corpus_batches_and_trains_as_stt_tpu(tmp_path):
    alphabet_path = tmp_path / "alphabet.txt"
    alphabet_path.write_text("".join(f"{c}\n" for c in " abcdefghijklmnopqrstuvwxyz'"))
    rng = np.random.RandomState(7)
    chapter = tmp_path / "corpus" / "LibriSpeech" / "dev-clean" / "19" / "198"
    chapter.mkdir(parents=True)
    lines = []
    for i in range(4):
        seqid = f"19-198-{i:04d}"
        write_flac(str(chapter / f"{seqid}.flac"), utterance(0.8 + 0.2 * i, RATE, rng), RATE)
        lines.append(f"{seqid} {' '.join(['SHE HAD', 'YOUR DARK', 'SUIT IN', 'GREASY WASH'][:i + 1])}\n")
    text(chapter / "19-198.trans.txt", "".join(lines))
    csvs = {}
    for package in PACKAGES:
        target = tmp_path / package
        shutil.copytree(tmp_path / "corpus", target)
        [csvs[package]] = importlib.import_module(f"{package}.tools.import_librivox").import_sets(
            str(target), ["dev-clean"], base_url=None)
    got = list(create_batches([csvs["stt_tpu_torch"]], Alphabet(str(alphabet_path)),
                              FeatureConfig(), batch_size=4))
    want = list(jax_create_batches([csvs["stt_tpu"]], JaxAlphabet(str(alphabet_path)),
                                   JaxFeatureConfig(), batch_size=4))
    assert len(got) == len(want) == 1
    (batch, ids), (jbatch, jids) = got[0], want[0]
    assert [os.path.relpath(i, tmp_path / "stt_tpu_torch") for i in ids] == \
        [os.path.relpath(i, tmp_path / "stt_tpu") for i in jids] and len(ids) == 4
    for field in ("feature_lengths", "labels", "label_lengths"):
        np.testing.assert_array_equal(getattr(batch, field).numpy(),
                                      np.asarray(getattr(jbatch, field)), err_msg=field)
    np.testing.assert_allclose(batch.features.numpy(), np.asarray(jbatch.features),
                               rtol=0, atol=FEATURE_TOL)

    tol = TOL["float32"]
    geometry = dict(n_input=26, n_context=9, n_hidden=64, n_cell_dim=64, n_out=29,
                    dropout_rates=(0.0,) * 6)
    jax_cfg, cfg = JaxModelConfig(**geometry), ModelConfig(**geometry)
    params = jax.device_get(init_params(jax.random.PRNGKey(0), jax_cfg))
    arrays = [np.asarray(getattr(jbatch, f)) for f in
              ("features", "feature_lengths", "labels", "label_lengths")]
    optimizer = jax_create_optimizer(learning_rate=LR)
    jstate = jax_create_train_state(None, jax_cfg, optimizer, params=params)
    _, jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(params, jax_batch(arrays), None,
                                                              jax_cfg)
    jstate, jm = jax_make_train_step(jax_cfg, optimizer)(jstate, jax_batch(arrays),
                                                          jax.random.PRNGKey(9))
    state = create_train_state(cfg, device="cpu", model=params_from_numpy(params, cfg),
                               learning_rate=LR)
    state, m = make_train_step()(state, batch, 9)
    assert np.isfinite(m.loss.item()) and not m.non_finite.any()
    np.testing.assert_allclose(m.loss.item(), float(jm.loss), rtol=tol["loss"][0])
    np.testing.assert_allclose(m.grad_norm.item(), float(jm.grad_norm), rtol=tol["norm"])
    grads = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
    for key, want in flat(jgrads).items():
        assert rel_norm(grads[key], want) <= tol["grad"], (key, rel_norm(grads[key], want))
