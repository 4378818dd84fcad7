"""TIMIT importer (counterpart of bin/import_timit.py).

Layout: TIMIT/{TRAIN,TEST}/<dialect>/<speaker>/<utt>.{WAV,TXT}; the .WAV
files are NIST SPHERE (decoded with the in-tree reader; the reference
calls sox), converted to <utt>_rif.wav beside the source. Transcripts
come from the .TXT prompt files ("start end words..."), cleaned of
punctuation and lowercased. SA sentences (identical across all
speakers) are excluded, matching the reference's recommended setting.
Writes timit_{train,test,all}.csv.
"""

from __future__ import annotations

import argparse
import fnmatch
import os
import re

from stt_tpu_torch.tools.importers import extract_archive, write_samples_csv

PUNCT = re.compile(r"[.,;\"!?:-]")


def clean(word: str) -> str:
    return PUNCT.sub("", word.lower())


def read_prompt(txt_path: str) -> str:
    with open(txt_path, encoding="utf-8", errors="replace") as f:
        words = f.read().split()[2:]  # drop the start/end sample counts
    return " ".join(clean(w) for w in words).strip()


def preprocess_data(data_dir: str, include_sa: bool = False):
    from stt_tpu_torch.data.sph import sph_to_wav

    target = os.path.join(data_dir, "TIMIT")
    if not os.path.isdir(target):
        archive = os.path.join(data_dir, "TIMIT-LDC93S1.tgz")
        if not os.path.isfile(archive):
            raise FileNotFoundError(
                f"place TIMIT-LDC93S1.tgz (from LDC) at {archive} or "
                f"extract it to {target}"
            )
        extract_archive(archive, target)

    sets = {"train": [], "test": []}
    for root, _, files in os.walk(target):
        for name in sorted(fnmatch.filter(files, "*.WAV")):
            if not include_sa and name.upper().startswith("SA"):
                continue
            sph = os.path.join(root, name)
            wav = sph[:-4] + "_rif.wav"
            if not os.path.isfile(wav):
                sph_to_wav(sph, wav)
            transcript = read_prompt(sph[:-4] + ".TXT")
            row = (wav, os.path.getsize(wav), transcript)
            lowered = sph.lower()
            if "train" in lowered:
                sets["train"].append(row)
            elif "test" in lowered:
                sets["test"].append(row)

    csvs = []
    for subset in ("train", "test"):
        csv_path = os.path.join(data_dir, f"timit_{subset}.csv")
        write_samples_csv(csv_path, sets[subset])
        csvs.append(csv_path)
    all_path = os.path.join(data_dir, "timit_all.csv")
    write_samples_csv(all_path, sets["train"] + sets["test"])
    csvs.append(all_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", help="dir containing TIMIT/ or TIMIT-LDC93S1.tgz")
    parser.add_argument("--include_sa", action="store_true",
                        help="keep the SA calibration sentences")
    args = parser.parse_args(argv)
    preprocess_data(args.data_dir, include_sa=args.include_sa)


if __name__ == "__main__":
    main()
