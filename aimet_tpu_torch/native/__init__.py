"""The host library in C++, bound with ctypes — counterpart of
``aimet_tpu/native/__init__.py``, with its own copy of the sources:

- ``src/scheduler.cpp``: the continuous-batching scheduler
  (``NativeScheduler``);
- ``src/encoding_search.cpp``: the calibration searches the encoding
  analyzers call (``sqnr_search``, ``sqnr_search_batch``,
  ``percentile_range``, ``mse_search``).

At first use g++ builds both sources into one library under
``aimet_tpu_torch/_build/native-<hash>/``, keyed by a hash of the sources
and the flags (as ``_build`` keys the kernels), so an edited source
rebuilds and an unchanged one loads as it is. A build or load that fails
raises with the compiler's output: nothing falls back to Python on its
own. The Python scheduler is the caller's choice (``use_native=False``);
the numpy searches in ``quantization/encoding_analyzer.py`` are the
searches' plain versions, which the tests compare against.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .._build import BUILD_ROOT

SOURCES = tuple(Path(__file__).resolve().parent / "src" / name
                for name in ("scheduler.cpp", "encoding_search.cpp"))
CXXFLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
LIB_NAME = "libaimet_native.so"
PDF_SIZE = 512


def find_cxx() -> str:
    """The C++ compiler: ``$CXX`` if set, else ``g++`` on the PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx or not (os.access(cxx, os.X_OK) or shutil.which(cxx)):
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH to "
                           "build the native host library")
    return cxx


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}"


def build() -> Path:
    """Compile (if not yet built) and return the library's path. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    lib = build_dir() / LIB_NAME
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # a file of this process's own, renamed into place: concurrent first
    # uses (test workers) never load each other's half-written library
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}")
    out = subprocess.run([find_cxx(), *CXXFLAGS, *map(str, SOURCES), "-o",
                          str(tmp)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"building the native host library failed (rc "
                           f"{out.returncode}):\n{out.stdout}")
    os.replace(tmp, lib)
    return lib


_I, _VP, _I64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
_D = ctypes.c_double
_IP = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_DP = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
SIGNATURES = {                      # name -> (restype, argtypes)
    # xleft, pdf, bw, symmetric, strict, unsigned, out (4)
    "aimet_sqnr_search": (_I, [_DP, _DP, _I, _I, _I, _I, _DP]),
    # xleft, pdf (n, 512), n, bw, symmetric, strict, unsigned, out (n, 4)
    "aimet_sqnr_search_batch": (_I, [_DP, _DP, _I, _I, _I, _I, _I, _DP]),
    # xleft, pdf, percentile, out (2)
    "aimet_percentile_range": (_I, [_DP, _DP, _D, _DP]),
    # xleft, pdf, bw, symmetric, strict, unsigned, out (2)
    "aimet_mse_search": (_I, [_DP, _DP, _I, _I, _I, _I, _DP]),
    "cb_create": (_VP, [_I, _I]),
    "cb_destroy": (None, [_VP]),
    "cb_submit": (_I64, [_VP, _I, _I, _I]),
    "cb_admit": (_I, [_VP, ctypes.POINTER(_I64)]),
    "cb_start": (_I, [_VP, _I, _I]),
    "cb_record": (_I, [_VP, _I, _I]),
    "cb_active": (_I, [_VP]),
    "cb_pending": (_I, [_VP]),
    "cb_active_slots": (_I, [_VP, _IP]),
    "cb_decode_state": (None, [_VP, _IP, _IP]),
    "cb_request_done": (_I, [_VP, _I64]),
    "cb_request_generated": (_I, [_VP, _I64]),
    "cb_evict": (_I, [_VP, _I64]),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded host library, built at first use; raises if it cannot
    be built or loaded."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading the native host library {path} "
                           f"failed: {e}") from e
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


def sqnr_search(xleft, pdf, bitwidth: int, symmetric: bool,
                strict_symmetric: bool = False,
                unsigned_symmetric: bool = False
                ) -> Tuple[float, float, float, float]:
    """The SQNR (TF-enhanced) search over one 512-bin PDF: (min, max,
    delta, offset)."""
    out = np.zeros(4)
    library().aimet_sqnr_search(_f64(xleft), _f64(pdf), bitwidth,
                                int(symmetric), int(strict_symmetric),
                                int(unsigned_symmetric), out)
    return tuple(float(v) for v in out)


def sqnr_search_batch(xleft, pdf, bitwidth: int, symmetric: bool,
                      strict_symmetric: bool = False,
                      unsigned_symmetric: bool = False) -> np.ndarray:
    """The SQNR search over each row of xleft / pdf (n, 512) in one call:
    (n, 4) of (min, max, delta, offset)."""
    xleft, pdf = _f64(xleft), _f64(pdf)
    if xleft.shape != pdf.shape or xleft.ndim != 2 \
            or xleft.shape[1] != PDF_SIZE:
        raise ValueError(f"xleft / pdf must both be (n, {PDF_SIZE}): "
                         f"{xleft.shape}, {pdf.shape}")
    out = np.zeros((xleft.shape[0], 4))
    library().aimet_sqnr_search_batch(
        xleft, pdf, xleft.shape[0], bitwidth, int(symmetric),
        int(strict_symmetric), int(unsigned_symmetric), out)
    return out


def percentile_range(xleft, pdf, percentile: float) -> Tuple[float, float]:
    """The percentile-clipped (min, max) of one PDF."""
    out = np.zeros(2)
    library().aimet_percentile_range(_f64(xleft), _f64(pdf),
                                     float(percentile), out)
    return float(out[0]), float(out[1])


def mse_search(xleft, pdf, bitwidth: int, symmetric: bool,
               strict_symmetric: bool = False,
               unsigned_symmetric: bool = False) -> Tuple[float, float]:
    """The (min, max) candidate of least pdf-weighted fake-quant MSE."""
    out = np.zeros(2)
    library().aimet_mse_search(_f64(xleft), _f64(pdf), bitwidth,
                               int(symmetric), int(strict_symmetric),
                               int(unsigned_symmetric), out)
    return float(out[0]), float(out[1])


class NativeScheduler:
    """ctypes wrapper over the C++ continuous-batching scheduler: admission
    queue, slot lifecycle, termination (the JAX package's methods and
    returns)."""

    def __init__(self, num_slots: int, max_len: int):
        self._lib = library()
        self._h = ctypes.c_void_p(self._lib.cb_create(num_slots, max_len))
        self.num_slots = num_slots

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cb_destroy(h)
            self._h = None

    def submit(self, prompt_len: int, max_new_tokens: int,
               eos_id: Optional[int]) -> int:
        return int(self._lib.cb_submit(
            self._h, prompt_len, max_new_tokens,
            -1 if eos_id is None else eos_id))

    def admit(self) -> Tuple[int, Optional[int]]:
        """(slot, uid) for the next admitted request, or (-1, None)."""
        uid = ctypes.c_int64(-1)
        slot = int(self._lib.cb_admit(self._h, ctypes.byref(uid)))
        return slot, (int(uid.value) if slot >= 0 else None)

    def start(self, slot: int, first_token: int) -> bool:
        """Record a request's first token after its prefill; True if that
        finished it (the slot is free again)."""
        r = self._lib.cb_start(self._h, slot, first_token)
        if r < 0:
            raise RuntimeError(f"scheduler: slot {slot} has no request")
        return bool(r)

    def record(self, slot: int, token: int) -> bool:
        """Record one decoded token; True if it finished the request."""
        r = self._lib.cb_record(self._h, slot, token)
        if r < 0:
            raise RuntimeError(f"scheduler: slot {slot} has no request")
        return bool(r)

    @property
    def num_active(self) -> int:
        return int(self._lib.cb_active(self._h))

    @property
    def num_pending(self) -> int:
        return int(self._lib.cb_pending(self._h))

    def active_slots(self) -> List[int]:
        out = np.zeros(self.num_slots, np.int32)
        n = int(self._lib.cb_active_slots(self._h, out))
        return out[:n].tolist()

    def decode_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """(last_tokens, positions) int32 arrays over all slots."""
        toks = np.zeros(self.num_slots, np.int32)
        pos = np.zeros(self.num_slots, np.int32)
        self._lib.cb_decode_state(self._h, toks, pos)
        return toks, pos

    def request_done(self, uid: int) -> bool:
        return self._lib.cb_request_done(self._h, uid) == 1

    def request_generated(self, uid: int) -> int:
        return int(self._lib.cb_request_generated(self._h, uid))

    def evict(self, uid: int) -> bool:
        """Drop a finished request's record (after its output is read), so
        a long-running server stays bounded."""
        return self._lib.cb_evict(self._h, uid) == 1
