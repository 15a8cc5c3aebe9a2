"""Minimal from-scratch NIfTI-1 reader/writer (no nibabel dependency).

A copy of the pure-Python reader and writer of ``glfusion_tpu/data/nifti.py``
(the port imports nothing of ``glfusion_tpu``). Echo videos are (H, W, T) or
(1, H, W, T) volumes in the NIfTI-1 single-file format (.nii / .nii.gz):
348-byte header, Fortran-ordered voxels at ``vox_offset``. The native C++
decoder of the JAX package is ROADMAP M15.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def needs_scaling(scl_slope: float, scl_inter: float) -> bool:
    """NIfTI-1 scaling predicate: ``scl_slope == 0`` means no scaling
    (``scl_inter`` is ignored too); non-finite slope/inter count as unset."""
    return (np.isfinite(scl_slope) and np.isfinite(scl_inter)
            and scl_slope != 0.0
            and not (scl_slope == 1.0 and scl_inter == 0.0))


def _read_bytes(path: str | Path) -> bytes:
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_nifti_py(path: str | Path) -> np.ndarray:
    """Read a NIfTI-1 volume in its natural (x, y, ...) shape."""
    return parse_nifti_bytes(_read_bytes(path), name=str(path),
                             gzipped=False)


def parse_nifti_bytes(data: bytes, name: str = "<bytes>",
                      gzipped: bool = None) -> np.ndarray:
    """Parse a NIfTI-1 volume from in-memory bytes (.nii or .nii.gz).

    ``gzipped=None`` sniffs the gzip magic.
    """
    if gzipped is None:
        gzipped = data[:2] == b"\x1f\x8b"
    raw = gzip.decompress(data) if gzipped else data
    if len(raw) < 348:
        raise ValueError(f"{name}: truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        if struct.unpack_from(">i", raw, 0)[0] == 348:
            return _parse(raw, ">", name)
        raise ValueError(f"{name}: bad sizeof_hdr {sizeof_hdr}")
    return _parse(raw, "<", name)


def _parse(raw: bytes, bo: str, path) -> np.ndarray:
    dim = struct.unpack_from(f"{bo}8h", raw, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    datatype = struct.unpack_from(f"{bo}h", raw, 70)[0]
    vox_offset = int(struct.unpack_from(f"{bo}f", raw, 108)[0])
    scl_slope = struct.unpack_from(f"{bo}f", raw, 112)[0]
    scl_inter = struct.unpack_from(f"{bo}f", raw, 116)[0]
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad magic {magic!r}")
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=vox_offset or 352)
    arr = data.reshape(shape, order="F")
    if needs_scaling(scl_slope, scl_inter):
        arr = (arr.astype(np.float32) * np.float32(scl_slope)
               + np.float32(scl_inter))
    return np.ascontiguousarray(arr)


def nifti_bytes(arr: np.ndarray, gz: bool = True) -> bytes:
    """Serialize an array as NIfTI-1 single-file bytes (optionally gzipped)."""
    arr = np.asarray(arr)
    if arr.dtype not in _CODES:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    hdr = bytearray(352)  # 348 header + 4 extension bytes
    struct.pack_into("<i", hdr, 0, 348)
    dim = [arr.ndim] + list(arr.shape) + [1] * (7 - arr.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[arr.dtype])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *([1.0] * 8))  # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + arr.tobytes(order="F")
    return gzip.compress(payload, compresslevel=1) if gz else payload


def write_nifti(path: str | Path, arr: np.ndarray) -> None:
    """Write a NIfTI-1 single-file volume (gzipped iff path ends with .gz)."""
    path = str(path)
    data = nifti_bytes(arr, gz=path.endswith(".gz"))
    with open(path, "wb") as f:
        f.write(data)
