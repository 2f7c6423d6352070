"""Minimal self-contained NIfTI-1 reader/writer (numpy only).

Port of ``fast_cwdm_tpu/data/nifti.py``: the NIfTI-1 subset BraTS uses
(single-file ``.nii``/``.nii.gz``, scalar dtypes, scl slope/inter,
sform/qform affines), with the nibabel-like calls
``load(path).get_fdata()``, ``img.affine``, ``img.header`` and
``save(Nifti1Image(data, affine, header), path)``.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

HDR_SIZE = 348
VOX_OFFSET = 352

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
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class Nifti1Header:
    dim: np.ndarray  # int16[8]
    datatype: int
    bitpix: int
    pixdim: np.ndarray  # float32[8]
    vox_offset: float
    scl_slope: float
    scl_inter: float
    qform_code: int
    sform_code: int
    quatern: np.ndarray  # float32[3] (b, c, d)
    qoffset: np.ndarray  # float32[3]
    srow: np.ndarray  # float32[3,4]
    descrip: bytes = b""
    endian: str = "<"
    raw: bytes | None = field(default=None, repr=False)

    def get_data_shape(self):
        return tuple(int(d) for d in self.dim[1 : 1 + int(self.dim[0])])

    def get_zooms(self):
        return tuple(float(z) for z in self.pixdim[1 : 1 + int(self.dim[0])])


def _parse_header(buf: bytes) -> Nifti1Header:
    (size,) = struct.unpack("<i", buf[:4])
    endian = "<"
    if size != HDR_SIZE:
        (size,) = struct.unpack(">i", buf[:4])
        if size != HDR_SIZE:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
        endian = ">"
    e = endian
    dim = np.frombuffer(buf[40:56], dtype=e + "i2").copy()
    datatype, bitpix = struct.unpack(e + "hh", buf[70:74])
    pixdim = np.frombuffer(buf[76:108], dtype=e + "f4").copy()
    vox_offset, scl_slope, scl_inter = struct.unpack(e + "fff", buf[108:120])
    descrip = buf[148:228].rstrip(b"\x00")
    qform_code, sform_code = struct.unpack(e + "hh", buf[252:256])
    quatern = np.frombuffer(buf[256:268], dtype=e + "f4").copy()
    qoffset = np.frombuffer(buf[268:280], dtype=e + "f4").copy()
    srow = np.frombuffer(buf[280:328], dtype=e + "f4").reshape(3, 4).copy()
    magic = buf[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"bad NIfTI magic {magic!r}")
    return Nifti1Header(
        dim=dim,
        datatype=int(datatype),
        bitpix=int(bitpix),
        pixdim=pixdim,
        vox_offset=float(vox_offset),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        qform_code=int(qform_code),
        sform_code=int(sform_code),
        quatern=quatern,
        qoffset=qoffset,
        srow=srow,
        descrip=descrip,
        endian=endian,
        raw=buf[:HDR_SIZE],
    )


def _affine_from_header(h: Nifti1Header) -> np.ndarray:
    if h.sform_code > 0:
        aff = np.eye(4)
        aff[:3, :] = h.srow
        return aff
    if h.qform_code > 0:
        b, c, d = (float(x) for x in h.quatern)
        a2 = max(0.0, 1.0 - b * b - c * c - d * d)
        a = np.sqrt(a2)
        R = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ]
        )
        qfac = 1.0 if h.pixdim[0] >= 0 else -1.0
        zooms = np.array([h.pixdim[1], h.pixdim[2], h.pixdim[3] * qfac])
        aff = np.eye(4)
        aff[:3, :3] = R * zooms
        aff[:3, 3] = h.qoffset
        return aff
    aff = np.diag([h.pixdim[1], h.pixdim[2], h.pixdim[3], 1.0])
    return aff


class Nifti1Image:
    """nibabel-alike image object."""

    def __init__(self, dataobj, affine=None, header: Nifti1Header | None = None):
        self.dataobj = np.asarray(dataobj)
        self.header = header
        if affine is None:
            affine = (
                _affine_from_header(header) if header is not None else np.eye(4)
            )
        self.affine = np.asarray(affine, dtype=np.float64)

    @property
    def shape(self):
        return self.dataobj.shape

    def get_fdata(self) -> np.ndarray:
        data = self.dataobj.astype(np.float64)
        h = self.header
        if h is not None and h.scl_slope not in (0.0,) and not np.isnan(
            h.scl_slope
        ):
            # NaN scl_inter means "no offset" (nibabel semantics)
            inter = 0.0 if np.isnan(h.scl_inter) else h.scl_inter
            if h.scl_slope != 1.0 or inter != 0.0:
                data = data * h.scl_slope + inter
        return data


def _read_bytes(path: str) -> bytes:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


class NiftiHeaderImage:
    """Header-only view: ``.header`` / ``.affine`` / ``.shape`` without
    decoding the voxels."""

    def __init__(self, header: Nifti1Header):
        self.header = header
        self.affine = np.asarray(_affine_from_header(header), np.float64)
        self.shape = tuple(header.get_data_shape())


def load_header(path: str) -> NiftiHeaderImage:
    """Parse only the 348-byte header (a gzip stream decompresses just its
    first block), for callers that need the geometry and not the voxels."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        hdr = f.read(HDR_SIZE)
    return NiftiHeaderImage(_parse_header(hdr))


def load(path: str) -> Nifti1Image:
    blob = _read_bytes(path)
    h = _parse_header(blob[:HDR_SIZE])
    shape = h.get_data_shape()
    np_dtype = np.dtype(_DTYPES[h.datatype]).newbyteorder(h.endian)
    count = int(np.prod(shape)) if shape else 0
    off = int(h.vox_offset) or VOX_OFFSET
    data = np.frombuffer(blob, dtype=np_dtype, count=count, offset=off)
    data = data.reshape(shape, order="F")
    return Nifti1Image(data, header=h)


def _build_header(
    data: np.ndarray,
    affine: np.ndarray,
    zooms=None,
    descrip: bytes = b"fast-cwdm-tpu-torch",
) -> bytes:
    buf = bytearray(HDR_SIZE)
    struct.pack_into("<i", buf, 0, HDR_SIZE)
    ndim = data.ndim
    dim = np.zeros(8, dtype="<i2")
    dim[0] = ndim
    dim[1 : 1 + ndim] = data.shape
    buf[40:56] = dim.tobytes()
    code = _CODES[np.dtype(data.dtype)]
    struct.pack_into("<hh", buf, 70, code, data.dtype.itemsize * 8)
    pixdim = np.ones(8, dtype="<f4")
    pixdim[0] = 1.0
    if zooms is not None:
        pixdim[1 : 1 + len(zooms)] = zooms
    buf[76:108] = pixdim.tobytes()
    struct.pack_into("<fff", buf, 108, float(VOX_OFFSET), 1.0, 0.0)
    d = descrip[:79]
    buf[148 : 148 + len(d)] = d
    struct.pack_into("<hh", buf, 252, 0, 1)  # qform 0, sform 1
    srow = np.asarray(affine, dtype="<f4")[:3, :4]
    buf[280:328] = srow.tobytes()
    buf[344:348] = b"n+1\x00"
    return bytes(buf)


def save(img: Nifti1Image, path: str, compresslevel: int = 1) -> None:
    """Write NIfTI-1 (.nii / .nii.gz).

    ``compresslevel=1`` matches nibabel's default deflate level — level 9
    costs seconds per 240³ float32 volume for ~5% size; mtime is pinned to
    0 so outputs are byte-reproducible.
    """
    data = np.asarray(img.dataobj)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if np.dtype(data.dtype) not in _CODES:
        data = data.astype(np.float32)
    hdr = _build_header(
        data,
        img.affine,
        zooms=(
            img.header.get_zooms()[: data.ndim]
            if img.header is not None
            else None
        ),
    )
    payload = hdr + b"\x00" * (VOX_OFFSET - HDR_SIZE) + data.tobytes(order="F")
    if str(path).endswith(".gz"):
        with open(path, "wb") as raw:
            with gzip.GzipFile(
                filename="",  # keep the FNAME field out of the header
                fileobj=raw, mode="wb", compresslevel=compresslevel, mtime=0,
            ) as f:
                f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
