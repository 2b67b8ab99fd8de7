"""``tpu_paxos_torch.native``: C++ host-side fast paths via ctypes (port
of ``tpu_paxos/native``).

``validate.cpp`` beside this module (the port's own copy of the JAX
package's) is compiled with g++ at first use into ``build/native_torch/``
next to the repo root and loaded with ``ctypes``.  It computes the
whole-run checks ``harness/validate.py`` routes arrays of
``>= 1 << 16`` cells through (agreement, the chosen value per instance,
exactly-once) and the decision-log renderer for real and no-op vids.

Unlike the JAX package, nothing falls back: a failed build raises
:class:`NativeBuildError` with g++'s output.  The numpy versions in
``harness/validate.py`` and ``replay/decision_log.py`` stay as the plain
versions the tests hold these against.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "validate.cpp")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_BUILD_DIR = os.path.join(_REPO, "build", "native_torch")
_LIB_PATH = os.path.join(_BUILD_DIR, "libtpupaxos_torch.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """g++ could not build ``validate.cpp`` (its output is the message)."""


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    # a unique temporary file and an atomic replace: concurrent first
    # builds (parallel test workers) never interleave into one library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                capture_output=True, text=True,
            )
        except OSError as e:
            raise NativeBuildError(f"g++ could not be run: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ failed to build {_SRC} (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB_PATH


def load() -> ctypes.CDLL:
    """Build the library if needed and load it (once per process);
    raises :class:`NativeBuildError` on a failed build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.tp_check_agreement.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tp_check_agreement.restype = ctypes.c_int
        lib.tp_chosen_per_instance.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.tp_chosen_per_instance.restype = None
        lib.tp_check_unique.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tp_check_unique.restype = ctypes.c_int
        lib.tp_render_decision_log.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.tp_render_decision_log.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises
    instead of returning False."""
    return load() is not None


def check_agreement(learned: np.ndarray) -> int | None:
    """First instance where two nodes learned different values, or
    None when all replicas agree."""
    lib = load()
    learned = np.ascontiguousarray(learned, np.int32)
    bad = ctypes.c_int64(-1)
    rc = lib.tp_check_agreement(learned, learned.shape[0], learned.shape[1], ctypes.byref(bad))
    return int(bad.value) if rc else None


def chosen_per_instance(learned: np.ndarray) -> np.ndarray:
    """Per instance: the vid the first knowing node learned (in node
    order), or NONE where no node knows a value.  Where knowing nodes
    disagree this is not the max over them that the numpy version in
    ``harness/validate`` takes; callers check agreement first."""
    lib = load()
    learned = np.ascontiguousarray(learned, np.int32)
    out = np.empty(learned.shape[0], np.int32)
    lib.tp_chosen_per_instance(learned, learned.shape[0], learned.shape[1], out)
    return out


def check_unique(chosen: np.ndarray, max_vid: int = -1) -> int | None:
    """A real vid chosen at two instances, or None when exactly-once
    holds.  ``max_vid >= 0`` enables the dense-bitset path; a vid above
    the bound falls back to the sort path, so the verdict never depends
    on the bound being right."""
    lib = load()
    chosen = np.ascontiguousarray(chosen, np.int32)
    dup = ctypes.c_int32(-1)
    rc = lib.tp_check_unique(chosen, len(chosen), max_vid, ctypes.byref(dup))
    if rc == 2:  # bound too small for the data: retry unbounded
        dup = ctypes.c_int32(-1)
        rc = lib.tp_check_unique(chosen, len(chosen), -1, ctypes.byref(dup))
    return int(dup.value) if rc else None


def render_decision_log(
    chosen_vid: np.ndarray,
    chosen_ballot: np.ndarray,
    stride: int,
    n_instances: int,
) -> str:
    """The reference value grammar (ref multi/paxos.cpp:18-22) for real
    and no-op vids.  Membership-change vids need the host intern table:
    callers with those use ``replay/decision_log.decision_log``."""
    lib = load()
    cv = np.ascontiguousarray(chosen_vid, np.int32)
    cb = np.ascontiguousarray(chosen_ballot, np.int32)
    need = lib.tp_render_decision_log(cv, cb, len(cv), stride, n_instances, None, 0)
    if need == 0:
        return ""
    buf = ctypes.create_string_buffer(need)
    wrote = lib.tp_render_decision_log(cv, cb, len(cv), stride, n_instances, buf, need)
    if wrote != need:
        raise RuntimeError(f"native renderer wrote {wrote} bytes, expected {need}")
    return buf.raw[:need].decode()
