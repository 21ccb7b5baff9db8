"""ctypes bindings for the C++ tokenizer (port of the tokenizer half of
ggmlsharp_tpu/io/native.py).

``native/tokenize.cpp`` is compiled by g++ on first use into the package's
``_build/`` directory (as ``libtokenize-<hash>.so``, the hash over the
source and the flags), never loaded prebuilt. If it cannot be built or
loaded, NativeSPM / NativeBPE raise: a tokenizer asked for the native
encoder never falls back to Python quietly. The JAX module's other half
(wire -> TPU plane repacking) has no counterpart: the port's planes are the
wire fields.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..kernels._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "tokenize.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread",
             "-Wall", "-shared")
ABI_VERSION = 1
_LOCK = threading.Lock()
_LIB = None


def library_path() -> str:
    if not os.path.isfile(SOURCE):
        raise RuntimeError(f"native tokenizer source {SOURCE} is missing")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libtokenize-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the tokenizer library if it is not built yet; returns its
    path. Raises RuntimeError if g++ fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run {cxx}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def load():
    """The tokenizer library, built and bound once a process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            if lib.tokenize_abi_version() != ABI_VERSION:
                raise RuntimeError("native tokenizer ABI version mismatch")
            P8, P64 = ctypes.POINTER(ctypes.c_uint8), \
                ctypes.POINTER(ctypes.c_uint64)
            P32, PF = ctypes.POINTER(ctypes.c_int32), \
                ctypes.POINTER(ctypes.c_float)
            i32, vp = ctypes.c_int32, ctypes.c_void_p
            lib.spm_create.restype = vp
            lib.spm_create.argtypes = [P8, P64, PF, i32, P32, i32]
            lib.spm_encode.restype = i32
            lib.spm_encode.argtypes = [vp, P8, i32, P32, i32]
            lib.spm_destroy.argtypes = [vp]
            lib.bpe_create.restype = vp
            lib.bpe_create.argtypes = [P8, P64, i32, P8, P64, i32, i32]
            lib.bpe_encode_pieces.restype = i32
            lib.bpe_encode_pieces.argtypes = [
                vp, P8, ctypes.POINTER(ctypes.c_int64), i32, P32, i32]
            lib.bpe_destroy.argtypes = [vp]
            _LIB = lib
    return _LIB


def tokenizer_available() -> bool:
    """Whether the tokenizer library builds and loads here; never raises
    for a missing compiler or a library that fails to load."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _blob(strings):
    """UTF-8 bytes of ``strings`` joined, and their uint64 offsets."""
    bs = [s.encode("utf-8") for s in strings]
    offs = np.zeros(len(bs) + 1, np.uint64)
    np.cumsum([len(b) for b in bs], out=offs[1:])
    blob = np.frombuffer(b"".join(bs), np.uint8) if any(bs) else \
        np.zeros(1, np.uint8)
    return np.ascontiguousarray(blob), offs


def _call_grow(fn, data_size):
    """Call fn(out) with an output buffer, once more with the size the
    library asks for if it was too small."""
    out = np.empty(max(16, data_size * 2), np.int32)
    n = fn(out)
    if n < 0:
        out = np.empty(-n, np.int32)
        n = fn(out)
    return out[:n].tolist()


class NativeSPM:
    """A C++ SPM vocabulary: encode() runs the O(n log n) priority-queue
    merge loop, with the Python greedy rescan's ids."""

    def __init__(self, tokens, scores, byte_ids, unk_id: int):
        self._lib = load()
        blob, offs = _blob(tokens)
        sc = np.asarray(scores, np.float32)
        bi = np.full(256, -1, np.int32)
        for b, i in byte_ids.items():
            bi[b] = i
        self._h = self._lib.spm_create(
            _u8(blob), _ptr(offs, ctypes.c_uint64), _ptr(sc, ctypes.c_float),
            len(tokens), _ptr(bi, ctypes.c_int32), unk_id)

    def encode(self, working_text: str):
        """working_text: the text with the space prefix and the U+2581
        substitution already applied."""
        data = np.frombuffer(working_text.encode("utf-8"), np.uint8)
        if data.size == 0:
            return []
        data = np.ascontiguousarray(data)
        return _call_grow(lambda out: self._lib.spm_encode(
            self._h, _u8(data), data.size, _ptr(out, ctypes.c_int32),
            out.size), data.size)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.spm_destroy(self._h)


class NativeBPE:
    """The C++ byte-level BPE merge loop over pre-mapped pieces, with the
    Python merge loop's ids."""

    def __init__(self, tokens, merges, unk_id: int = 0):
        self._lib = load()
        tblob, toffs = _blob(tokens)
        mblob, moffs = _blob([p for m in merges for p in m.split(" ", 1)])
        self._h = self._lib.bpe_create(
            _u8(tblob), _ptr(toffs, ctypes.c_uint64), len(tokens),
            _u8(mblob), _ptr(moffs, ctypes.c_uint64), len(merges), unk_id)

    def encode_pieces(self, pieces):
        """pieces: pre-mapped strings -> one flat id list, one native call."""
        blob, offs = _blob(pieces)
        offs = offs.astype(np.int64)
        if offs[-1] == 0:
            return []
        return _call_grow(lambda out: self._lib.bpe_encode_pieces(
            self._h, _u8(blob), _ptr(offs, ctypes.c_int64), len(pieces),
            _ptr(out, ctypes.c_int32), out.size), int(offs[-1]))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bpe_destroy(self._h)
