"""Build a CUDA source of `csrc/` into a shared library and load it.

Every hand-written kernel of the package goes through here: `nvcc` compiles
the source for `sm_90a` into `build/kernels/` at first use (one library per
source and flag set, named by a digest of both, so a changed source or model
shape is a new file), and `ctypes` loads it. The sources have a plain C
interface and include none of PyTorch's headers, which keeps a build at
seconds. Nothing is built when a module is imported, and a failed build
raises: there is no other path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: CUDA kernels are built on the machine with the card")


@dataclass
class Library:
    """One built library: the ctypes handle, nvcc's seconds (0 when the file
    was already there) and what ptxas printed."""

    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float
    build_log: str

    def ptxas_lines(self):
        return [l.strip() for l in self.build_log.splitlines()
                if "registers" in l or "spill" in l or "stack frame" in l]


def build(source: str, defines: Sequence[str] = (), headers: Sequence[str] = ()) -> Library:
    """Compile `csrc/<source>` with the `-D` flags `defines` (first use
    only) and load it. `headers` are the files of `csrc/` the source
    includes; they enter the digest."""
    src = CSRC / source
    flags = [*NVCC_FLAGS, *defines]
    digest = hashlib.sha1(
        src.read_bytes() + b"".join((CSRC / h).read_bytes() for h in headers)
        + " ".join(flags).encode()
    ).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    log = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):\n{res.stderr}")
        log.write_text(res.stderr)
        os.replace(tmp, path)
    return Library(ctypes.CDLL(str(path)), path, seconds, log.read_text() if log.exists() else "")
