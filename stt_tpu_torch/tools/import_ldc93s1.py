"""LDC93S1 importer: the single-utterance smoke corpus
(parity: bin/import_ldc93s1.py). Zero-egress friendly: give it
--source_dir pointing at existing LDC93S1.wav/.txt files (e.g. the
reference's data/smoke_test) and it produces the standard CSV; with
network access it downloads from the catalog URL.

Run: python -m stt_tpu_torch.tools.import_ldc93s1 target_dir \
       [--source_dir /root/reference/data/smoke_test]
"""

from __future__ import annotations

import argparse
import os
import shutil

LDC93S1_BASE_URL = "https://catalog.ldc.upenn.edu/desc/addenda/"


def import_ldc93s1(target_dir: str, source_dir: str = "") -> str:
    os.makedirs(target_dir, exist_ok=True)
    wav_path = os.path.join(target_dir, "LDC93S1.wav")
    txt_path = os.path.join(target_dir, "LDC93S1.txt")
    if not os.path.isfile(wav_path):
        if source_dir:
            shutil.copy(os.path.join(source_dir, "LDC93S1.wav"), wav_path)
            shutil.copy(os.path.join(source_dir, "LDC93S1.txt"), txt_path)
        else:
            import urllib.request

            for name, dest in (("LDC93S1.wav", wav_path), ("LDC93S1.txt", txt_path)):
                urllib.request.urlretrieve(LDC93S1_BASE_URL + name, dest)
    with open(txt_path) as f:
        raw = f.read().strip()
    # the txt has leading sample indices: "0 46797 She had your ..."
    transcript = " ".join(raw.split()[2:]).lower().replace(".", "").strip()
    csv_path = os.path.join(target_dir, "ldc93s1.csv")
    with open(csv_path, "w") as f:
        f.write("wav_filename,wav_filesize,transcript\n")
        f.write(f"{wav_path},{os.path.getsize(wav_path)},{transcript}\n")
    print(f"Wrote {csv_path}")
    return csv_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("target_dir")
    parser.add_argument("--source_dir", default="")
    args = parser.parse_args(argv)
    import_ldc93s1(args.target_dir, args.source_dir)


if __name__ == "__main__":
    main()
