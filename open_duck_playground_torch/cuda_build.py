"""Build a source of `csrc/` into a shared library and load it.

Every hand-written kernel of the package goes through here: `nvcc` compiles
the source for `sm_90a` into `build/kernels/` at first use (one library per
source and flag set, named by a digest of both, so a changed source or model
shape is a new file), and `ctypes` loads it. The sources have a plain C
interface and include none of PyTorch's headers, which keeps a build at
seconds. With `host=True` the host's C++ compiler builds a CPU source the
same way into `build/host/` (the native ONNX runtime of `export/`).
Nothing is built when a module is imported, and a failed build raises:
there is no other path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: CUDA kernels are built on the machine with the card")


def host_cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found")


def _host_cpu() -> bytes:
    """The CPU's feature flags: `-march=native` code built on one CPU may not
    run on another, so a host library is named by the CPU it was built on."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.machine().encode()
    flags = next((l for l in text.splitlines() if l.startswith(("flags", "Features"))), "")
    return (platform.machine() + flags).encode()


@dataclass
class Library:
    """One built library: the ctypes handle, the compiler's seconds (0 when the file
    was already there) and what ptxas printed."""

    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float
    build_log: str

    def ptxas_lines(self):
        return [l.strip() for l in self.build_log.splitlines()
                if "registers" in l or "spill" in l or "stack frame" in l]


def build(source: str, defines: Sequence[str] = (), headers: Sequence[str] = (),
          host: bool = False) -> Library:
    """Compile `csrc/<source>` with the `-D` flags `defines` (first use
    only) and load it: with nvcc for the card, or with `host=True` with the
    host's C++ compiler. `headers` are the files of `csrc/` the source
    includes; they enter the digest."""
    src = CSRC / source
    flags = [*(HOST_FLAGS if host else NVCC_FLAGS), *defines]
    out_dir = HOST_BUILD_DIR if host else BUILD_DIR
    digest = hashlib.sha1(
        src.read_bytes() + b"".join((CSRC / h).read_bytes() for h in headers)
        + " ".join(flags).encode() + (_host_cpu() if host else b"")
    ).hexdigest()[:12]
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"lib{src.stem}_{digest}.so"
    log = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        # per process and thread: two builds of one library may run at once
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        compiler = host_cxx() if host else nvcc()
        res = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{compiler} failed on {source} ({res.returncode}):\n{res.stderr}")
        log.write_text(res.stderr)
        os.replace(tmp, path)
    return Library(ctypes.CDLL(str(path)), path, seconds, log.read_text() if log.exists() else "")
