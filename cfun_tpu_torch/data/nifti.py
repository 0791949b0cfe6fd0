"""Self-contained NIfTI-1 reader/writer (numpy only): the port's copy of
``cfun_tpu/data/nifti.py``.

The reference depends on nibabel for all volume IO (utils.py:304-308,
heart_main.py:300-304).  This module implements the subset of NIfTI-1 the
pipelines need: single-file .nii / .nii.gz, the common integer/float
dtypes, scl_slope/inter scaling, sform/qform affines, and byte-swapped
files.  ``save`` writes .nii.gz at gzip level 1, as the JAX package does:
the two packages' files of equal inputs are byte-identical when written
under the same name in the same second (the gzip header holds both).

Arrays are returned index-ordered [i, j, k] (x fastest in storage), matching
nibabel's ``get_data()`` layout the reference treats as [H, W, D].
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

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
    1024: np.int64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _read_bytes(path: str) -> bytes:
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _quaternion_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    qfac = -1.0 if hdr["pixdim"][0] < 0 else 1.0
    r = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    zooms = np.array([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = r * zooms
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def load(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a .nii / .nii.gz volume.

    Returns (data [i, j, k(, t)], affine [4, 4]).  scl_slope/inter are
    applied when meaningful (slope not in {0, 1} or inter != 0), promoting
    to float32 -- nibabel ``get_fdata`` semantics.
    """
    raw = _read_bytes(path)
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        if struct.unpack_from(">i", raw, 0)[0] != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, raw, off)

    dim = u("8h", 40)
    datatype = u("h", 70)[0]
    pixdim = u("8f", 76)
    vox_offset = int(u("f", 108)[0])
    scl_slope, scl_inter = u("2f", 112)
    qform_code, sform_code = u("h", 252)[0], u("h", 254)[0]
    quatern = u("6f", 256)
    srow = np.array(u("12f", 280), np.float64).reshape(3, 4)
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    ndim = dim[0]
    shape = tuple(dim[1:1 + max(ndim, 3)])
    shape = tuple(max(1, s) for s in shape)
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    # storage is x-fastest: C-reshape reversed dims, transpose to [i, j, k, ...]
    data = data.reshape(shape[::-1]).transpose(range(len(shape) - 1, -1, -1))
    data = np.asarray(data, dtype=dtype.newbyteorder("="))
    while data.ndim > 3 and data.shape[-1] == 1:
        data = data[..., 0]

    if (scl_slope not in (0.0, 1.0) and not np.isnan(scl_slope)) or \
            (scl_inter not in (0.0,) and not np.isnan(scl_inter)):
        slope = scl_slope if scl_slope not in (0.0,) and not np.isnan(scl_slope) else 1.0
        inter = scl_inter if not np.isnan(scl_inter) else 0.0
        data = data.astype(np.float32) * np.float32(slope) + np.float32(inter)

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srow
    elif qform_code > 0:
        hdr = {"quatern_b": quatern[0], "quatern_c": quatern[1],
               "quatern_d": quatern[2], "qoffset_x": quatern[3],
               "qoffset_y": quatern[4], "qoffset_z": quatern[5],
               "pixdim": pixdim}
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])
    return data, affine


def save(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None,
         zooms: Optional[Tuple[float, float, float]] = None) -> None:
    """Write a single-file NIfTI-1 volume (.nii or .nii.gz)."""
    if affine is None:
        affine = np.eye(4)
    data = np.ascontiguousarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    if zooms is None:
        zooms = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(3))
    pixdim = [1.0, *zooms] + [1.0] * (7 - 3)

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<h", hdr, 252, 0)      # qform_code
    struct.pack_into("<h", hdr, 254, 1)      # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].astype(np.float32).ravel())
    hdr[344:348] = b"n+1\x00"

    # storage x-fastest = transpose then C-order bytes
    payload = data.transpose(range(ndim - 1, -1, -1)).tobytes()
    blob = bytes(hdr) + payload
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
