"""Build the REFERENCE ctcdecode CTC beam-search decoder as an external
parity/perf oracle (the port of tools/reference_decoder_oracle.py).

The reference implements its decoder in C++
(/root/reference/native_client/ctcdecode/ctc_beam_search_decoder.cpp,
path_trie.cpp, scorer.cpp, alphabet.cc) on top of vendored KenLM, OpenFST
and flashlight sources. This module compiles those sources **out of
tree** (objects and binary under build/ctcdecode_oracle/ at the root of
the checkout, which git ignores; the read-only reference tree is never
modified and nothing is copied into this repository) and links them
against stt_tpu_torch/tools/oracle_main.cpp, a small original driver that
feeds raw float64 emissions through DecoderState::init/next/decode and
prints JSON. It builds wherever the reference tree is mounted, and
returns None elsewhere.

tests/test_torch_reference_decoder_oracle.py gates transcript/score/
timestep parity of the port's decoders (Python and native) against this
binary.

Run: python -m stt_tpu_torch.tools.reference_decoder_oracle
"""

import glob
import json
import os
import struct
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

REF = "/root/reference/native_client"
BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "ctcdecode_oracle",
)
BIN = os.path.join(BUILD, "bin", "oracle")
_DRIVER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "oracle_main.cpp")

_INCLUDES = [
    REF,
    f"{REF}/kenlm",
    f"{REF}/ctcdecode",
    f"{REF}/ctcdecode/third_party/openfst-1.6.7/src/include",
    f"{REF}/ctcdecode/third_party/ThreadPool",
    f"{REF}/ctcdecode/third_party/object_pool",
    f"{REF}/ctcdecode/third_party/flashlight",
]
_FLAGS = [
    "-O3", "-DNDEBUG", "-DKENLM_MAX_ORDER=6", "-std=c++14", "-fPIC",
    "-Wno-unused-local-typedefs", "-Wno-sign-compare", "-w",
    # the vendored 2017-era sources predate newer libstdc++ header
    # hygiene; force-include what they assume transitively
    "-include", "limits", "-include", "stdexcept", "-include", "cstdint",
]


def _sources():
    kenlm = (
        glob.glob(f"{REF}/kenlm/util/*.cc")
        + glob.glob(f"{REF}/kenlm/lm/*.cc")
        + glob.glob(f"{REF}/kenlm/util/double-conversion/*.cc")
    )
    kenlm = [
        f for f in kenlm
        if not (f.endswith("main.cc") or f.endswith("test.cc")
                or f.endswith("unittest.cc"))
    ]
    openfst = glob.glob(
        f"{REF}/ctcdecode/third_party/openfst-1.6.7/src/lib/*.cc"
    )
    fl = f"{REF}/ctcdecode/third_party/flashlight/flashlight/lib"
    flashlight = [
        f"{fl}/common/String.cpp",
        f"{fl}/common/System.cpp",
        f"{fl}/text/decoder/LexiconDecoder.cpp",
        f"{fl}/text/decoder/LexiconFreeDecoder.cpp",
        f"{fl}/text/decoder/lm/ConvLM.cpp",
        f"{fl}/text/decoder/lm/KenLM.cpp",
        f"{fl}/text/decoder/lm/ZeroLM.cpp",
        f"{fl}/text/decoder/Trie.cpp",
        f"{fl}/text/decoder/Utils.cpp",
        f"{fl}/text/dictionary/Dictionary.cpp",
        f"{fl}/text/dictionary/Utils.cpp",
    ]
    first_party = [
        f"{REF}/ctcdecode/ctc_beam_search_decoder.cpp",
        f"{REF}/ctcdecode/scorer.cpp",
        f"{REF}/ctcdecode/path_trie.cpp",
        f"{REF}/ctcdecode/decoder_utils.cpp",
        f"{REF}/alphabet.cc",
    ]
    return kenlm + openfst + flashlight + first_party + [_DRIVER]


def build_oracle(jobs=None, verbose=False):
    """Compile + link the oracle; returns the binary path, or None if the
    reference tree is unavailable or compilation fails. Object files are
    cached under BUILD/obj across calls."""
    if os.path.isfile(BIN):
        return BIN
    if not os.path.isdir(f"{REF}/ctcdecode"):
        return None
    # serialize concurrent builders (pytest-xdist workers)
    os.makedirs(BUILD, exist_ok=True)
    import fcntl

    with open(os.path.join(BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_locked(jobs, verbose)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_locked(jobs, verbose):
    if os.path.isfile(BIN):
        return BIN
    obj_dir = os.path.join(BUILD, "obj")
    os.makedirs(obj_dir, exist_ok=True)
    os.makedirs(os.path.dirname(BIN), exist_ok=True)
    inc = [f"-I{d}" for d in _INCLUDES]
    srcs = _sources()

    def compile_one(src):
        rel = os.path.relpath(src, "/").replace("/", "_")
        obj = os.path.join(obj_dir, rel + ".o")
        if os.path.isfile(obj) and os.path.getmtime(obj) >= os.path.getmtime(src):
            return obj, None
        r = subprocess.run(
            ["g++", *_FLAGS, *inc, "-c", src, "-o", obj],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            return obj, f"{src}: {r.stderr[-2000:]}"
        return obj, None

    jobs = jobs or max(2, os.cpu_count() or 2)
    with ThreadPoolExecutor(jobs) as pool:
        compiled = list(pool.map(compile_one, srcs))
    errors = [e for _, e in compiled if e]
    if errors:
        if verbose:
            print("\n".join(errors))
        return None
    objs = [o for o, _ in compiled]
    r = subprocess.run(
        ["g++", *objs, "-o", BIN, "-lpthread", "-lrt"],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        if verbose:
            print(r.stderr[-2000:])
        return None
    return BIN


def run_oracle(
    probs_list,
    alphabet_path=None,
    utf8=False,
    scorer_path=None,
    alpha=0.0,
    beta=0.0,
    beam=500,
    cutoff_prob=1.0,
    cutoff_top_n=40,
    num_results=1,
    hot_words=None,
    reps=1,
    chunk=0,
    binary=None,
    env=None,
):
    """Run the reference decoder on a list of [T, C] float probability
    arrays; returns the parsed JSON result dict."""
    import numpy as np

    binary = binary or build_oracle()
    if binary is None:
        raise RuntimeError("reference decoder oracle not built")
    classes = probs_list[0].shape[1]
    with tempfile.TemporaryDirectory(prefix="oracle_probs_") as td:
        args = [binary, "--classes", str(classes), "--beam", str(beam),
                "--cutoff_prob", repr(float(cutoff_prob)),
                "--cutoff_top_n", str(cutoff_top_n),
                "--num_results", str(num_results),
                "--reps", str(reps)]
        if chunk:
            args += ["--chunk", str(chunk)]
        if utf8:
            args += ["--utf8"]
        else:
            args += ["--alphabet", alphabet_path]
        if scorer_path:
            args += ["--scorer", scorer_path,
                     "--alpha", repr(float(alpha)),
                     "--beta", repr(float(beta))]
        for w, b in (hot_words or {}).items():
            args += ["--hot", f"{w}={b}"]
        for i, probs in enumerate(probs_list):
            path = os.path.join(td, f"u{i}.f64")
            np.ascontiguousarray(probs, dtype=np.float64).tofile(path)
            args.append(f"{path}:{probs.shape[0]}")
        r = subprocess.run(args, capture_output=True, text=True,
                           timeout=3600, env=env)
        if r.returncode != 0:
            raise RuntimeError(f"oracle failed: {r.stderr[-1000:]}")
        return json.loads(r.stdout)


if __name__ == "__main__":
    path = build_oracle(verbose=True)
    print(path or "BUILD FAILED")
