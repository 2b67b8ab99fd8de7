"""Build and load the port's hand-written CUDA kernels.

Each source ``tpu_paxos_torch/csrc/<name>.cu`` has a plain C interface
and is compiled with ``nvcc -arch=sm_90a -shared`` into
``build/tpu_paxos_torch/<name>_sm_90a_<sha256 prefix>.so`` beside the
package, keyed by the source's sha256, then loaded with ``ctypes``.
Every library exports ``<name>_error_string(int)`` for its launchers'
``cudaGetLastError()`` codes.  A failed build or launch raises; nothing
falls back to a plain version.

Building happens at first use (nothing is compiled at import), so the
CPU-only test machine imports every module without ``nvcc``.
:func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tpu_paxos_torch")
ARCH = "sm_90a"

_libs: dict = {}
_lock = threading.Lock()


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    with open(source(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{ARCH}_{digest}.so")


def build_command(compiler: str, name: str, out: str) -> list[str]:
    return [
        compiler, f"-arch={ARCH}", "-O3", "-std=c++17", "-shared",
        "-Xcompiler", "-fPIC", "-o", out, source(name),
    ]


def build_all(names) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together; returns ``{name: path}``.  Raises
    with the compiler's output on any failure."""
    out = {name: library_path(name) for name in names}
    procs = {}
    compiler = None
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name, path in out.items():
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            compiler = compiler or nvcc()
            procs[name] = (tmp, subprocess.Popen(
                build_command(compiler, name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {source(name)}:\n{log}")
        else:
            os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, signatures: dict):
    """Build ``name`` if needed and load it once per process.
    ``signatures`` maps each exported launcher to ``(argtypes,
    restype)``; ``<name>_error_string`` is declared here."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check_launch(lib, name: str, code: int, what: str) -> None:
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({code})")


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and
    shape on ``device``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
