"""TED-LIUM v2 importer (counterpart of bin/import_ted.py).

Layout: TEDLIUM_release2/{train,dev,test}/ with sph/ talk recordings and
stm/ segment transcripts. Each sph is decoded with the in-tree SPHERE
reader (the reference shells out to sox), sliced into one wav per STM
segment, and written to {set}/wav/<talk>-<start>-<stop>.wav; CSVs are
ted-{train,dev,test}.csv.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from stt_tpu_torch.data.stm import parse_stm_file
from stt_tpu_torch.tools.importers import extract_archive, write_samples_csv

SAMPLE_RATE = 16000


def split_talk(stm_file: str, wav_dir: str, sph_dir: str):
    from stt_tpu_torch.data.audio import resample, write_wav
    from stt_tpu_torch.data.sph import read_sph

    talk = os.path.splitext(os.path.basename(stm_file))[0]
    sph = os.path.join(sph_dir, talk + ".sph")
    if not os.path.isfile(sph):
        print(f"Warning: missing recording {sph}")
        return []
    audio, rate = read_sph(sph)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    if rate != SAMPLE_RATE:
        audio = resample(audio, rate, SAMPLE_RATE)
        rate = SAMPLE_RATE
    rows = []
    for seg in parse_stm_file(stm_file):
        chunk = audio[
            int(seg.start_time * rate) : int(seg.stop_time * rate)
        ]
        if not len(chunk) or not seg.transcript.strip():
            continue
        name = f"{talk}-{seg.start_time}-{seg.stop_time}.wav"
        wav_path = os.path.join(wav_dir, name)
        if not os.path.isfile(wav_path):
            write_wav(wav_path, np.asarray(chunk), rate)
        rows.append(
            (os.path.abspath(wav_path), os.path.getsize(wav_path),
             seg.transcript)
        )
    return rows


def import_release(data_dir: str, release_dir: str = "TEDLIUM_release2"):
    extracted = os.path.join(data_dir, release_dir)
    archive = os.path.join(data_dir, release_dir + ".tar.gz")
    if not os.path.isdir(extracted) and os.path.isfile(archive):
        extract_archive(archive, data_dir, expected_dir=extracted)
    csvs = []
    for subset in ("train", "dev", "test"):
        stm_dir = os.path.join(extracted, subset, "stm")
        sph_dir = os.path.join(extracted, subset, "sph")
        wav_dir = os.path.join(extracted, subset, "wav")
        os.makedirs(wav_dir, exist_ok=True)
        rows = []
        for stm_file in sorted(glob.glob(os.path.join(stm_dir, "*.stm"))):
            rows.extend(split_talk(stm_file, wav_dir, sph_dir))
        csv_path = os.path.join(data_dir, f"ted-{subset}.csv")
        write_samples_csv(csv_path, rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", help="dir containing TEDLIUM_release2[.tar.gz]")
    args = parser.parse_args(argv)
    import_release(args.data_dir)


if __name__ == "__main__":
    main()
