"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/lib<name>-<hash>.so`` beside this file; the hash of the source
and of the shared headers (``csrc/*.cuh``) names the library, so an
edited source builds anew and an unchanged one is reused. :func:`build_all` starts one ``nvcc`` per source, all at once.
The libraries load with ``ctypes``; nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

from repro_torch.kernels import KernelError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (looked in $CUDA_HOME/bin and PATH): "
                       "the CUDA kernels build from source at first use")


def _target(name: str) -> Path:
    """The library's path, named by the hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build_all(names=None) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together. Raises with nvcc's output on a
    failed build (``KernelError``)."""
    names = sources() if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD, suffix=".so")
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc))
    errors = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)        # atomic: concurrent builders agree
        else:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
    if errors:
        raise KernelError("\n".join(errors))
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            build_all([name])
        try:
            lib = _libs[name] = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"cannot load {path.name}: {e}") from e
    return lib
