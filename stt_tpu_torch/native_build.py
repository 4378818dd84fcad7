"""Build at first use of the port's host C and C++ code (`native/`): the
CTC decoder (`decode.native`), the C API library and `stt_client`
(`serve.capi`), and the decoder's two harnesses (`build_decoder_smoke`,
`build_prof_decoder`). Each is built into `build/native/` at the root of the
checkout; a failed build raises RuntimeError with the compiler's message.
"""

from __future__ import annotations

import os
import subprocess
import threading
from pathlib import Path
from typing import List

NATIVE = Path(__file__).resolve().parent / "native"
BUILD = Path(__file__).resolve().parents[1] / "build" / "native"
DECODER_SOURCE = NATIVE / "ctc_decoder.cpp"
DECODER_SMOKE = BUILD / "decoder_smoke_asan"
PROF_DECODER = BUILD / "prof_decoder"


def build_if_stale(command: List[str], inputs: List[Path], output: Path, what: str) -> None:
    """Run `command` with "-o <temporary file>" appended unless `output` is
    newer than every one of `inputs` (the first of which is the source) and
    was built by the same command (kept in `output`.cmd), so a change of
    flags, or a build directory that moves to another machine's Python, is
    built again. The temporary file, written beside `output`, is renamed
    into place, so a process building at the same moment never loads a
    half-written one. Raises RuntimeError with the compiler's message when
    the build fails."""
    source = inputs[0]
    missing = [str(p) for p in inputs if not p.is_file()]
    if missing:
        raise RuntimeError(f"{what}: source missing: {', '.join(missing)}")
    stamp = output.with_name(output.name + ".cmd")
    line = " ".join(command)
    if (output.is_file() and all(output.stat().st_mtime >= p.stat().st_mtime for p in inputs)
            and stamp.is_file() and stamp.read_text() == line):
        return
    output.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    tmp = output.with_name(f"{output.name}.{tag}")
    try:
        result = subprocess.run([*command, "-o", str(tmp)], capture_output=True, text=True,
                                timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build {what} from {source}: {e}") from e
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{command[0]} failed to build {what} from {source}:\n{result.stderr}"
        )
    os.replace(tmp, output)
    stamp_tmp = stamp.with_name(f"{stamp.name}.{tag}")
    stamp_tmp.write_text(line)
    os.replace(stamp_tmp, stamp)


def build_decoder_smoke() -> Path:
    """The C ABI harness of the native decoder (`native/decoder_smoke.cc`
    with `native/ctc_decoder.cpp`) under ASan and UBSan, built if needed;
    run it with no argument, then with a .scorer path: it prints
    "decoder_smoke OK" and exits 0 when every round passed."""
    source = NATIVE / "decoder_smoke.cc"
    # stt_tpu's Makefile: its CXXFLAGS, then its sanitize target's own
    build_if_stale(["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-g",
                    "-fsanitize=address,undefined", "-fno-omit-frame-pointer",
                    str(DECODER_SOURCE), str(source)],
                   [source, DECODER_SOURCE], DECODER_SMOKE, "the decoder's sanitizer harness")
    return DECODER_SMOKE


def build_prof_decoder() -> Path:
    """The gprof driver of the native decoder (`native/prof_decoder.cc`,
    which includes `native/ctc_decoder.cpp`), built if needed. It decodes 500
    frames 10 times at beam 500, prints the first transcript on stderr, and
    writes gmon.out into its working directory: run it from a scratch one."""
    source = NATIVE / "prof_decoder.cc"
    build_if_stale(["g++", "-O2", "-pg", "-std=c++17", str(source)], [source, DECODER_SOURCE],
                   PROF_DECODER, "the decoder's profiling driver")
    return PROF_DECODER
