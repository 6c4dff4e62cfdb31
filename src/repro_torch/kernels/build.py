"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Each source under ``csrc/`` compiles with nvcc into its own shared library
with a plain C interface, for ``sm_90a``. A library is keyed by a hash of
its source and flags and lands in ``_build/`` next to this file (listed in
.gitignore); it is built at first use on the card, and ``build_all``
starts one nvcc per source at once. Nothing here runs at import time: the
CPU tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_attention.cu", "grouped_gemm.cu", "flash_attention.cu",
           "matmul.cu", "decode_attention.cu", "rwkv_wkv.cu",
           "sparse_gather.cu", "paged_span_attention.cu",
           "paged_decode_attention.cu", "rwkv_wkv_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the repro_torch kernels")
    return found


def library_path(source: str) -> Path:
    """Where ``source``'s library lives: keyed by source bytes + flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source not built yet, all nvcc processes at once.
    Raises with nvcc's stderr on failure; ptxas's register and shared-
    memory report is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not out[s].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = []
    for s in todo:
        tmp = out[s].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    failures = []
    for s, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {s} (rc={proc.returncode}):\n{stderr}")
            continue
        out[s].with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out[s])  # atomic: concurrent builders never race
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([source])[source]))
        _loaded[source] = lib
    return lib
