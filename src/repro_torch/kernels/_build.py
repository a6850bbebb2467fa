"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each source in ``csrc/`` has a plain C interface (no PyTorch headers), so
nvcc compiles it in seconds.  It is built at first use into ``build/``
beside this file (listed in ``.gitignore``), under a name keyed by the
hash of the source, the shared headers (``csrc/*.cuh``) and the flags: an
edited source or header is rebuilt, an unchanged one is loaded as it is.  ``start_builds`` launches one nvcc per
source, all at once, and ``finish_builds`` waits for them, so a caller can
build every kernel in parallel.  ``scratch`` keeps the one fp32 buffer a
card in which a kernel's partial sums pass to the launch that sums them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_scratch: Dict[int, "torch.Tensor"] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled on a machine "
        "with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


def lib_path(name: str) -> Path:
    src = b"".join(f.read_bytes() for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def start_builds(names: List[str]) -> List[Tuple[str, Path, subprocess.Popen]]:
    """Start one nvcc per source not built yet; returns the running jobs."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, proc))
    return jobs


def finish_builds(jobs: List[Tuple[str, Path, subprocess.Popen]]) -> Dict[str, str]:
    """Wait for every job; returns each source's compiler output (register
    and shared-memory use from ``-Xptxas -v``).  Raises if one failed."""
    logs, failed = {}, []
    for name, out, proc in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def check_device(name: str, *tensors) -> None:
    """Raise unless every operand of kernel ``name`` lies on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands must share one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        finish_builds(start_builds([name]))
        _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return _loaded[name]


def scratch(dev: int, n: int):
    """fp32 scratch of at least n elements on card ``dev``: one buffer a
    card, grown to the largest n asked for and kept.  Every kernel that uses
    it (a split's partials and the launch that sums them) runs in stream
    order on the current stream and writes the partials it reads, so the
    callers share it."""
    import torch

    w = _scratch.get(dev)
    if w is None or w.numel() < n:
        w = _scratch[dev] = torch.empty((n,), dtype=torch.float32,
                                        device=torch.device("cuda", dev))
    return w
