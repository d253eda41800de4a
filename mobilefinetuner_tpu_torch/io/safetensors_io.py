"""SafeTensors reader/writer with the crc32 integrity manifest (port of
mobilefinetuner_tpu/io/safetensors_io.py, its pure-Python reference: the
native C++ engine is not ported).

The format: an 8-byte little-endian header length, a JSON header (tensor
entries plus an optional "__metadata__" of strings), the raw blob. BF16
has no numpy dtype: it is decoded to float32 from its u16 bits and
encoded with round-to-nearest-even. Files are byte-compatible with the
JAX package's: both read what either writes (tests/test_torch_io.py).

Every write is published atomically (tmp + fsync + rename), and
`save_safetensors` then publishes `<path>.manifest.json`: crc32 and size
of every tensor's stored bytes, which `verify_report`/`verify_file`
check. The functions take and return numpy arrays; torch tensors are
converted at the call sites.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np


class CheckpointIntegrityError(ValueError):
    """A checkpoint failed its integrity contract: unreadable or truncated
    file, missing or stale manifest, or a checksum mismatch."""


@contextlib.contextmanager
def atomic_publish(path: str):
    """Yield `<path>.tmp.<pid>` for the caller to write, then fsync it and
    os.replace it onto `path` (and fsync the directory entry where the
    platform allows). On an exception the tmp file is removed and the
    previous `path` is untouched."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        try:
            dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                          os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # no directory fsync here: the data fsync already landed
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


# safetensors dtype tag -> numpy dtype of the raw decode
_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
    "BF16": np.dtype("<u2"),
}
_TO_TAG = {
    np.dtype("float64"): "F64", np.dtype("float32"): "F32",
    np.dtype("float16"): "F16", np.dtype("int64"): "I64",
    np.dtype("int32"): "I32", np.dtype("int16"): "I16",
    np.dtype("int8"): "I8", np.dtype("uint8"): "U8", np.dtype("bool"): "BOOL",
}


def bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    return (raw_u16.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_u16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even on the truncated mantissa."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounding = 0x7FFF + ((u >> 16) & 1)
    return ((u + rounding) >> 16).astype(np.uint16)


class SafeTensorsReader:
    """Parses the header eagerly, memory-maps the blob, loads lazily."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            try:
                (header_len,) = struct.unpack("<Q", f.read(8))
                if header_len > os.path.getsize(path) - 8:
                    raise ValueError(
                        f"header length {header_len} exceeds file size")
                header = json.loads(f.read(header_len).decode("utf-8"))
            except (struct.error, ValueError) as e:
                raise ValueError(
                    f"{path}: malformed safetensors header: {e}") from e
            if not isinstance(header, dict):
                raise ValueError(f"{path}: malformed safetensors header: "
                                 f"not a JSON object")
        self.metadata: Dict[str, str] = header.pop("__metadata__", {}) or {}
        self.entries: Dict[str, dict] = header
        self._blob = np.memmap(path, dtype=np.uint8, mode="r",
                               offset=8 + header_len)

    def keys(self):
        return list(self.entries.keys())

    def shape_dtype(self, name: str) -> Tuple[tuple, str]:
        e = self.entries[name]
        return tuple(e["shape"]), e["dtype"]

    def load(self, name: str, promote_to_f32: bool = False) -> np.ndarray:
        """One tensor as a numpy array (a copy). BF16 decodes to float32;
        other dtypes keep their storage dtype unless promote_to_f32."""
        e = self.entries[name]
        tag = e["dtype"]
        if tag not in _DTYPES:
            raise ValueError(f"unsupported safetensors dtype {tag}")
        begin, end = e["data_offsets"]
        raw = np.frombuffer(self._blob[begin:end], dtype=_DTYPES[tag])
        arr = bf16_to_f32(raw) if tag == "BF16" else raw.copy()
        if promote_to_f32 and arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        return arr.reshape(e["shape"])

    def load_all(self, promote_to_f32: bool = False) -> Dict[str, np.ndarray]:
        return {k: self.load(k, promote_to_f32) for k in self.entries}

    def raw_bytes(self, name: str) -> bytes:
        """One tensor's stored payload bytes, undecoded (what the manifest
        checksums); a truncated blob returns fewer bytes."""
        begin, end = self.entries[name]["data_offsets"]
        return bytes(self._blob[begin:min(end, len(self._blob))])


# --------------------------- integrity manifest ------------------------------

MANIFEST_VERSION = 1


def manifest_path(path: str) -> str:
    return path + ".manifest.json"


def _write_manifest(path: str, entries: Dict[str, dict]) -> str:
    mp = manifest_path(path)
    payload = {"version": MANIFEST_VERSION,
               "file": os.path.basename(path),
               "tensors": entries}
    with atomic_publish(mp) as tmp:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, separators=(",", ":"), sort_keys=True)
    return mp


def verify_report(path: str) -> Tuple[str, Optional[str]]:
    """('ok', None), ('unverified', reason) for a file without manifest,
    or ('corrupt', reason). Never raises."""
    if not os.path.exists(path):
        return "corrupt", "missing_file"
    try:
        reader = SafeTensorsReader(path)
    except (ValueError, OSError, MemoryError) as e:
        return "corrupt", f"malformed:{type(e).__name__}"
    mp = manifest_path(path)
    if not os.path.exists(mp):
        return "unverified", "manifest_missing"
    try:
        with open(mp, "r", encoding="utf-8") as f:
            tensors = json.load(f)["tensors"]
        if not isinstance(tensors, dict):
            raise ValueError("tensors is not an object")
    except (ValueError, KeyError, OSError):
        return "corrupt", "manifest_unreadable"
    if set(tensors) != set(reader.entries):
        return "corrupt", "manifest_stale"
    for name, spec in tensors.items():
        raw = reader.raw_bytes(name)
        if len(raw) != spec.get("nbytes"):
            return "corrupt", f"size_mismatch:{name}"
        if (zlib.crc32(raw) & 0xFFFFFFFF) != spec.get("crc32"):
            return "corrupt", f"checksum_mismatch:{name}"
    return "ok", None


def verify_file(path: str) -> None:
    """CheckpointIntegrityError unless `path` verifies 'ok' (a missing
    manifest fails too)."""
    status, reason = verify_report(path)
    if status != "ok":
        raise CheckpointIntegrityError(
            f"{path}: integrity verification failed ({reason})")


def _encode_tensor(name, arr, bf16_keys) -> Tuple[str, tuple, bytes]:
    """(tag, shape, stored bytes) of one tensor: BF16 for keys in
    bf16_keys, the array's own dtype where the format has it, else F32."""
    arr = np.asarray(arr)
    if bf16_keys and name in bf16_keys:
        return ("BF16", arr.shape,
                f32_to_bf16_u16(arr.astype(np.float32)).tobytes())
    dtype = arr.dtype if arr.dtype in _TO_TAG else np.dtype(np.float32)
    return (_TO_TAG[dtype], arr.shape,
            np.ascontiguousarray(arr.astype(dtype, copy=False)).tobytes())


def save_safetensors(path: str, tensors: Dict[str, np.ndarray],
                     metadata: Optional[Dict[str, str]] = None,
                     bf16_keys: Optional[set] = None,
                     manifest: bool = True):
    """Write a safetensors file (tensors in the dict's order, header padded
    to 8 bytes as the HF writer pads it), published atomically, then its
    checksum manifest."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    sums: Dict[str, dict] = {}
    blobs = []
    offset = 0
    for name, arr in tensors.items():
        tag, shape, raw = _encode_tensor(name, arr, bf16_keys)
        sums[name] = {"crc32": zlib.crc32(raw) & 0xFFFFFFFF,
                      "nbytes": len(raw), "dtype": tag,
                      "shape": list(shape)}
        header[name] = {"dtype": tag, "shape": list(shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * (-len(hjson) % 8)
    with atomic_publish(path) as tmp:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(hjson)))
            f.write(hjson)
            for b in blobs:
                f.write(b)
    if manifest:
        _write_manifest(path, sums)
