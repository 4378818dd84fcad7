"""Build the port's CUDA sources into shared libraries, load them, and call
their entry points.

Each `csrc/<name>.cu` compiles with `nvcc` for sm_90a into
`build/kernels/lib<name>.so` at the root of the checkout, the first time a
wrapper needs it, and again only when the source or a `csrc/*.cuh` header
is newer than the library. The library has a plain C interface and is
loaded with ctypes; `check_tensors` and `launch` are what every wrapper
does around a call.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str, define: str = "") -> Path:
    """Where `csrc/<name>.cu` is built to; a variant built with the macro
    `define` set has a library of its own."""
    return BUILD_DIR / f"lib{name}{'.' + define.lower() if define else ''}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale(name: str, define: str = "") -> bool:
    """True when the library is missing or older than its source or any
    header in csrc/ (the sources share lstm_step.cuh)."""
    lib = library_path(name, define)
    inputs = [sources()[name], *CSRC.glob("*.cuh")]
    return not lib.exists() or lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(names: Iterable[str] = (), define: str = "") -> Dict[str, str]:
    """Compile the named sources (all when empty) that are out of date, one
    nvcc process per source, all started together, with the macro `define`
    set if one is given. Returns each built source's ptxas report."""
    names = [n for n in (list(names) or list(sources())) if _stale(n, define)]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        tmp = Path(f"{library_path(name, define)}.{os.getpid()}.tmp")
        flags = [*NVCC_FLAGS, *([f"-D{define}"] if define else [])]
        cmd = [nvcc, *flags, "-o", str(tmp), str(sources()[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{report}")
            continue
        os.replace(tmp, library_path(name, define))  # atomic when processes build at once
        if not define:
            (BUILD_DIR / f"{name}.ptxas.txt").write_text(report)
        reports[name] = report
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str, define: str = "") -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu` (with the macro `define` set,
    if given), building it if needed."""
    build([name], define)
    return ctypes.CDLL(str(library_path(name, define)))


def check_tensors(expected: Dict[str, Tuple[torch.Tensor, tuple, torch.dtype]], device) -> None:
    """Raise unless each named tensor has its shape and dtype, lies on
    `device` and is contiguous, as the kernels take their arguments."""
    for name, (tensor, shape, dtype) in expected.items():
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(tensor.shape)} {tensor.dtype}"
            )
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, expected {device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LSTM kernel for device {device}")


def launch(fn, name: str, device, *args) -> None:
    """Call the entry point `fn` with `args` and the current stream of
    `device`; raise if it reports a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
