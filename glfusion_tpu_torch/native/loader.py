"""ctypes bindings of the native NIfTI decoder (port of
``glfusion_tpu/native/loader.py`` and ``build.py``).

``csrc/nifti_reader.cpp`` is built at first use with ``g++`` into
``glfusion_tpu_torch/_build/libglnative-<hash>.so``, the hash taken over
the source and the flags, so a changed source builds and loads a fresh
path. The build writes a temporary file and renames it into place, so
processes that build at once never load a half-written library; nothing
else in the directory is touched.

The flags leave out ``-march=native`` and add ``-ffp-contract=off``: the
scaled decode ``f * slope + inter`` then rounds twice, as the pure
reader's numpy does, on every CPU. (JAX's build, ``-O3 -march=native``,
fuses it into one FMA where the CPU has one, and so returns scaled volumes
up to one float32 ulp from its pure reader.)

The contract is JAX's: an unscaled volume keeps its on-disk type through a
raw byte copy; one scaled by ``scl_slope``/``scl_inter`` comes back as
float32; scaled 32-bit integers, float64 and big-endian files go to the
pure reader (the single read raises, ``data.nifti.read_nifti`` falls
back); a batch raises if any file needs the pure reader, so the caller
falls back file by file. When the library cannot be built or loaded,
``native_available()`` is False and ``build_error()`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_PATH = PKG_DIR / "csrc" / "nifti_reader.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None
_lock = threading.Lock()


def library_path() -> Path:
    """The library of the current source and flags."""
    tag = hashlib.sha256(SRC_PATH.read_bytes() + " ".join(
        CXX_FLAGS + LIBS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libglnative-{tag}.so"


def compiler_version() -> str:
    """``g++ --version``'s first line ('' when there is no g++)."""
    try:
        res = subprocess.run([CXX, "--version"], capture_output=True,
                             text=True, timeout=30)
    except OSError:
        return ""
    return res.stdout.splitlines()[0] if res.stdout else ""


def build() -> Path:
    """Compile the decoder; returns the library path. Raises with the
    compiler's stderr when the build fails."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, str(SRC_PATH), "-o", tmp, *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):"
                               f"\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p, u8p, f32p = (ctypes.POINTER(ctypes.c_int64),
                       ctypes.POINTER(ctypes.c_uint8),
                       ctypes.POINTER(ctypes.c_float))
    paths = ctypes.POINTER(ctypes.c_char_p)
    sigs = {
        "gl_nifti_query_v2": [ctypes.c_char_p, i64p,
                              ctypes.POINTER(ctypes.c_int), i64p, f32p,
                              f32p],
        "gl_nifti_read_raw": [ctypes.c_char_p, u8p, ctypes.c_int64],
        "gl_nifti_read_many_raw": [paths, ctypes.c_int, u8p, i64p, i64p,
                                   ctypes.c_int],
        "gl_nifti_read_f32": [ctypes.c_char_p, f32p, ctypes.c_int64],
        "gl_nifti_read_many_f32": [paths, ctypes.c_int, f32p, i64p, i64p,
                                   ctypes.c_int],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _ERROR
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("GLFUSION_NO_NATIVE"):
            _ERROR = "switched off by GLFUSION_NO_NATIVE"
            return None
        try:
            path = library_path()
            if not path.exists():
                build()
            _LIB = _bind(ctypes.CDLL(str(path)))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _ERROR = f"{type(e).__name__}: {e}"
        return _LIB


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the decoder is not available (None when it is, or before the
    first attempt)."""
    _load()
    return _ERROR


# NIfTI datatype code → numpy type (the C++ decode table's)
_NIFTI_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
                 64: np.float64, 256: np.int8, 512: np.uint16,
                 768: np.uint32}
# types whose values the float32 decode core holds exactly (float64 and
# 32-bit integers can exceed its 24-bit mantissa: the pure reader)
_F32_EXACT = (np.uint8, np.int16, np.float32, np.int8, np.uint16)


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable ({_ERROR})")
    return lib


def _query(lib, path):
    """(shape, numel, dtype code, scl_slope, scl_inter) from the header."""
    dims = (ctypes.c_int64 * 8)()
    dtype, numel = ctypes.c_int(), ctypes.c_int64()
    slope, inter = ctypes.c_float(), ctypes.c_float()
    rc = lib.gl_nifti_query_v2(str(path).encode(), dims,
                               ctypes.byref(dtype), ctypes.byref(numel),
                               ctypes.byref(slope), ctypes.byref(inter))
    if rc != 0:
        raise IOError(f"native nifti query failed ({rc}): {path}")
    shape = tuple(int(dims[1 + i]) for i in range(int(dims[0])))
    return shape, int(numel.value), int(dtype.value), slope.value, inter.value


def _scaled(slope: float, inter: float) -> bool:
    """Whether the core applies scl_slope/scl_inter (the predicate of
    ``needs_scaling`` in the C++ source and in ``data/nifti.py``)."""
    from glfusion_tpu_torch.data.nifti import needs_scaling
    return needs_scaling(slope, inter)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_nifti_native(path: str | Path) -> np.ndarray:
    """One volume, with ``read_nifti_py``'s types: unscaled volumes in
    their on-disk type (a raw byte copy), scaled ones as float32."""
    lib = _lib()
    shape, numel, code, slope, inter = _query(lib, path)
    np_dtype = _NIFTI_DTYPES.get(code)
    if np_dtype is None:
        raise IOError(f"dtype {code} routed to the python reader")
    if not _scaled(slope, inter):
        nbytes = numel * np.dtype(np_dtype).itemsize
        out = np.empty(nbytes, np.uint8)
        rc = lib.gl_nifti_read_raw(str(path).encode(),
                                   _ptr(out, ctypes.c_uint8), nbytes)
        if rc != 0:  # 5: big-endian, which the python reader swaps
            raise IOError(f"native raw read failed ({rc}): {path}")
        return out.view(np_dtype).reshape(shape, order="F")
    if np_dtype not in _F32_EXACT:
        raise IOError(f"scaled dtype {code} routed to the python reader")
    out = np.empty(numel, np.float32)
    rc = lib.gl_nifti_read_f32(str(path).encode(),
                               _ptr(out, ctypes.c_float), numel)
    if rc != 0:
        raise IOError(f"native nifti read failed ({rc}): {path}")
    return out.reshape(shape, order="F")


def read_nifti_batch_native(paths: Sequence[str | Path],
                            num_threads: int = 0) -> list[np.ndarray]:
    """Many volumes on the decoder's thread pool (``num_threads`` 0: one
    a core), each of the type ``read_nifti_native`` gives it; raises when
    any file needs the pure reader."""
    lib = _lib()
    metas = [_query(lib, p) for p in paths]
    scaled = [_scaled(slope, inter) for *_, slope, inter in metas]
    dtypes = []
    for (_, _, code, _, _), sc in zip(metas, scaled):
        np_dtype = _NIFTI_DTYPES.get(code)
        if np_dtype is None or (sc and np_dtype not in _F32_EXACT):
            raise IOError(f"dtype {code} routed to the python reader")
        dtypes.append(np.float32 if sc else np_dtype)
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    if not any(scaled):  # raw bytes, no conversion
        sizes = [m[1] * np.dtype(d).itemsize for m, d in zip(metas, dtypes)]
        offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(
            np.int64) if sizes else np.zeros(0, np.int64)
        flat = np.empty(int(sum(sizes)), np.uint8)
        failed = lib.gl_nifti_read_many_raw(
            c_paths, n, _ptr(flat, ctypes.c_uint8),
            (ctypes.c_int64 * n)(*offsets.tolist()),
            (ctypes.c_int64 * n)(*sizes), num_threads)
        if failed:
            raise IOError(f"native batch read: {failed}/{n} failed")
        return [flat[o:o + s].view(d).reshape(m[0], order="F")
                for o, s, d, m in zip(offsets, sizes, dtypes, metas)]
    # a batch with a scaled file goes through the float32 core whole: its
    # unscaled files must be of types that core holds exactly
    if any(d not in _F32_EXACT for d in dtypes):
        raise IOError("mixed batch with a float32-inexact type: the python "
                      "reader")
    numels = [m[1] for m in metas]
    offsets = np.concatenate([[0], np.cumsum(numels[:-1])]).astype(np.int64)
    flat = np.empty(sum(numels), np.float32)
    failed = lib.gl_nifti_read_many_f32(
        c_paths, n, _ptr(flat, ctypes.c_float),
        (ctypes.c_int64 * n)(*offsets.tolist()),
        (ctypes.c_int64 * n)(*numels), num_threads)
    if failed:
        raise IOError(f"native batch read: {failed}/{n} failed")
    return [flat[o:o + k].reshape(m[0], order="F").astype(d, copy=False)
            for o, k, d, m in zip(offsets, numels, dtypes, metas)]
