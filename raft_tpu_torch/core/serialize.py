"""Array/scalar (de)serialization in NumPy ``.npy`` format
(``raft_tpu.core.serialize`` counterpart).

The byte layout is the JAX package's, byte for byte, so an index saved by
one package loads in the other: a dtype-name tag then an ``.npy`` payload
per array (bfloat16 stored as a uint16 bit view), fixed-width little-endian
scalars, the ``RAFT_TPU`` magic + kind + version preamble, and the v4
checksummed envelope (index version u32, payload length u64, CRC32 u32,
payload).
"""
from __future__ import annotations

import io
import os
import zlib
from typing import BinaryIO, Callable, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core.errors import CorruptIndexError
from raft_tpu_torch.robust import faults

SERIALIZATION_VERSION = 4
_MAGIC = b"RAFT_TPU"

# Dtypes npy cannot represent, stored via a bit-identical view.
_VIEW_AS = {"bfloat16": np.uint16}


def to_numpy(arr) -> np.ndarray:
    """Host numpy copy of a tensor or array-like; bfloat16 tensors come
    back as their uint16 bit view (numpy has no bfloat16)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(arr)


def _dtype_name(arr) -> str:
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            return "bfloat16"
        return to_numpy(arr[:0]).dtype.name
    return np.asarray(arr).dtype.name


def serialize_array(stream: BinaryIO, arr) -> None:
    """Write an array: a dtype-name tag followed by an ``.npy`` payload."""
    name = _dtype_name(arr)
    host = to_numpy(arr)
    serialize_string(stream, name)
    if name in _VIEW_AS:
        host = host.view(_VIEW_AS[name])
    np.save(stream, host, allow_pickle=False)


def from_numpy(host: np.ndarray, device=None, name: str = "") -> torch.Tensor:
    """Tensor on ``device`` from a host array (``name="bfloat16"`` restores
    a uint16 bit view)."""
    host = np.ascontiguousarray(host)
    if name == "bfloat16" or host.dtype.name == "bfloat16":
        t = torch.from_numpy(host.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(host.copy())
    return t.to(device) if device is not None else t


def as_tensor(x, device) -> torch.Tensor:
    """``x`` (a tensor or anything numpy takes) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return from_numpy(np.asarray(x), device)


def deserialize_array(stream: BinaryIO, device=None) -> torch.Tensor:
    """Read one tagged array and place it on ``device``."""
    name = deserialize_string(stream)
    host = np.load(stream, allow_pickle=False)
    return from_numpy(host, device, name)


_SCALAR_FMT = {
    "int32": "<i4",
    "int64": "<i8",
    "uint32": "<u4",
    "uint64": "<u8",
    "float32": "<f4",
    "float64": "<f8",
    "bool": "?",
}


def serialize_scalar(stream: BinaryIO, value: Union[int, float, bool], dtype: str) -> None:
    stream.write(np.asarray(value, dtype=_SCALAR_FMT[dtype]).tobytes())


def deserialize_scalar(stream: BinaryIO, dtype: str):
    dt = np.dtype(_SCALAR_FMT[dtype])
    buf = stream.read(dt.itemsize)
    if len(buf) != dt.itemsize:
        raise EOFError("truncated stream while reading scalar")
    return np.frombuffer(buf, dtype=dt)[0].item()


def serialize_string(stream: BinaryIO, s: str) -> None:
    data = s.encode("utf-8")
    serialize_scalar(stream, len(data), "uint32")
    stream.write(data)


def deserialize_string(stream: BinaryIO) -> str:
    n = deserialize_scalar(stream, "uint32")
    return stream.read(n).decode("utf-8")


def dump_header(stream: BinaryIO, kind: str, version: int = SERIALIZATION_VERSION) -> None:
    """Magic + index-kind + version preamble."""
    stream.write(_MAGIC)
    serialize_string(stream, kind)
    serialize_scalar(stream, version, "uint32")


def check_header(stream: BinaryIO, kind: str) -> int:
    magic = stream.read(len(_MAGIC))
    if magic != _MAGIC:
        raise ValueError(f"not a raft_tpu serialized object (bad magic {magic!r})")
    found = deserialize_string(stream)
    if found != kind:
        raise ValueError(f"expected serialized {kind!r}, found {found!r}")
    version = deserialize_scalar(stream, "uint32")
    if version > SERIALIZATION_VERSION:
        raise ValueError(
            f"serialization version {version} is newer than supported {SERIALIZATION_VERSION}"
        )
    return version


def save_stream(stream: BinaryIO, kind: str, version: int, body: bytes) -> None:
    """Write an index snapshot in the v4 checksummed envelope."""
    dump_header(stream, kind, SERIALIZATION_VERSION)
    serialize_scalar(stream, version, "uint32")
    serialize_scalar(stream, len(body), "uint64")
    serialize_scalar(stream, zlib.crc32(body) & 0xFFFFFFFF, "uint32")
    stream.write(body)


def load_stream(stream: BinaryIO, kind: str) -> Tuple[int, BinaryIO]:
    """Open an index snapshot: returns ``(index_version, payload_stream)``.
    v4 envelopes are length- and CRC-verified (:class:`CorruptIndexError`);
    v<=3 legacy streams are returned as-is, unchecked. The
    ``serialize.load`` fault seam fires after the header parse, before the
    payload is verified."""
    version = check_header(stream, kind)
    faults.fire("serialize.load", kind=kind)
    if version < 4:
        return version, stream
    index_version = int(deserialize_scalar(stream, "uint32"))
    length = int(deserialize_scalar(stream, "uint64"))
    crc = int(deserialize_scalar(stream, "uint32"))
    payload_offset = stream.tell() if stream.seekable() else None
    payload = stream.read(length)
    if len(payload) != length:
        raise CorruptIndexError(
            f"truncated {kind} snapshot: payload is {len(payload)} of {length} bytes",
            offset=payload_offset,
        )
    actual = zlib.crc32(payload) & 0xFFFFFFFF
    if actual != crc:
        raise CorruptIndexError(
            f"{kind} snapshot failed its CRC32 check",
            offset=payload_offset, expected_crc=crc, actual_crc=actual,
        )
    return index_version, io.BytesIO(payload)


def open_payload(path: str, kind: str, *, verify_crc: bool = True) -> Tuple[int, int, int]:
    """Locate the v4 payload inside the file at ``path`` without holding
    it in memory: returns ``(index_version, payload_offset, length)``.

    The lazy complement of :func:`load_stream` for :func:`mmap_array_at`:
    the header is parsed, the ``serialize.load`` seam fires, the CRC is
    verified by streaming the payload in 4 MiB chunks (skipped with
    ``verify_crc=False``) and the file is closed again. v<=3 streams have
    no framed payload and are rejected."""
    with open(path, "rb") as f:
        version = check_header(f, kind)
        faults.fire("serialize.load", kind=kind)
        if version < 4:
            raise ValueError(f"mmap loading needs a v4 envelope; {path!r} is v{version}")
        index_version = int(deserialize_scalar(f, "uint32"))
        length = int(deserialize_scalar(f, "uint64"))
        crc = int(deserialize_scalar(f, "uint32"))
        offset = f.tell()
        if verify_crc:
            actual = 0
            remaining = length
            while remaining:
                chunk = f.read(min(remaining, 4 << 20))
                if not chunk:
                    raise CorruptIndexError(
                        f"truncated {kind} snapshot: payload is {length - remaining} of "
                        f"{length} bytes",
                        offset=offset,
                    )
                actual = zlib.crc32(chunk, actual)
                remaining -= len(chunk)
            if actual & 0xFFFFFFFF != crc:
                raise CorruptIndexError(
                    f"{kind} snapshot failed its CRC32 check",
                    offset=offset, expected_crc=crc, actual_crc=actual & 0xFFFFFFFF,
                )
        return index_version, offset, length


def mmap_array_at(path: str, offset: int) -> Tuple[np.ndarray, int, str]:
    """Map the :func:`serialize_array` frame at ``offset`` in ``path``
    without copying it into RAM: returns ``(array, next_offset,
    dtype_name)``. The array is a read-only ``np.memmap`` over the npy
    data bytes, paged in as a gather touches its rows; a bfloat16 frame
    stays its uint16 bit view (numpy has no bfloat16), which
    ``dtype_name`` names, so that :func:`from_numpy` or a
    ``torch.bfloat16`` view restores it."""
    with open(path, "rb") as f:
        f.seek(offset)
        name = deserialize_string(f)
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        if fortran:
            raise ValueError("mmap loading supports C-order arrays only")
        data_offset = f.tell()
    arr = np.memmap(path, dtype=dtype, mode="r", offset=data_offset, shape=shape)
    next_offset = data_offset + int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return arr, next_offset, name


def atomic_write(path: str, writer: Callable[[BinaryIO], None]) -> str:
    """Run ``writer`` against a temp file, fsync, then rename onto
    ``path`` — a torn write can never be observed at ``path``."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path
