"""Minimal self-contained ONNX initializer reader (no ``onnx`` package).

The port's copy of ``waifu2x_tensorrt_tpu.models.onnx_reader`` (numpy
only; ``tests/test_torch_onnx_graph.py`` pins it to the reference). The
reference's model artifacts are ONNX files (README.md:11-12); this walks
the protobuf wire format directly and extracts the graph initializers
(name -> ndarray). Only the fields needed for weight extraction are
implemented:

  ModelProto.graph = 7 (message GraphProto)
  GraphProto.initializer = 5 (repeated message TensorProto)
  TensorProto.dims = 1 (repeated int64), .data_type = 2 (enum),
  .name = 8 (string), .float_data = 4, .int64_data = 7, .raw_data = 9,
  .external_data = 13 (repeated StringStringEntryProto),
  .data_location = 14 (enum: 0 DEFAULT, 1 EXTERNAL)

External-data artifacts (``torch.onnx.export`` splits initializers past
2 GB into a sidecar ``.data`` file; ``onnx.save_model(...,
save_as_external_data=True)`` does it for any size) resolve their
tensors from the sibling file named by the ``location`` entry when a
``base_dir`` is supplied; without one, or when the sidecar file is
missing, loading fails with :class:`OnnxExternalDataError` naming the
missing file (the reference hands such artifacts to nvonnxparser, which
resolves them the same way, img2img_build.cpp:88).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# ONNX TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
}


class OnnxExternalDataError(ValueError):
    """An initializer's bytes live in an external-data sidecar file that
    cannot be resolved (no base directory, missing/short file, or an
    unsafe location path). Named so callers (validate.py triage,
    Upscaler load) can distinguish "artifact needs its .data sibling"
    from a corrupt model."""


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, value


def _parse_string_entries(buf: bytes) -> dict[str, str]:
    """StringStringEntryProto: key = 1, value = 2 (both strings)."""
    key = val = ""
    for field, wire, value in _iter_fields(buf):
        if field == 1 and wire == 2:
            key = value.decode()
        elif field == 2 and wire == 2:
            val = value.decode()
    return {key: val}


def _read_external(name: str, entries: dict[str, str],
                   base_dir) -> bytes:
    """Resolve a data_location=EXTERNAL tensor's bytes from its sidecar
    file. Fails loud (OnnxExternalDataError) on every unresolvable case
    rather than silently yielding an empty tensor."""
    location = entries.get("location", "")
    if not location:
        raise OnnxExternalDataError(
            f"initializer {name!r} is marked EXTERNAL but carries no "
            "location entry (corrupt external_data)")
    if base_dir is None:
        raise OnnxExternalDataError(
            f"initializer {name!r} lives in external-data file "
            f"{location!r} but this entry point has no model directory "
            "to resolve it from; load via read_initializers/read_graph "
            "with the .onnx path")
    base = Path(base_dir).resolve()
    target = (base / location).resolve()
    if base not in target.parents and target != base:
        # the spec requires location to be relative to the model file;
        # reject traversal outside the model directory
        raise OnnxExternalDataError(
            f"initializer {name!r}: external-data location {location!r} "
            f"escapes the model directory {base}")
    if not target.is_file():
        raise OnnxExternalDataError(
            f"initializer {name!r}: external-data file {location!r} not "
            f"found next to the model (expected {target}); release "
            "artifacts with external data ship as a pair — copy the "
            "data file alongside the .onnx")
    offset = int(entries.get("offset", "0") or 0)
    length = int(entries.get("length", "-1") or -1)
    with open(target, "rb") as f:
        f.seek(offset)
        raw = f.read() if length < 0 else f.read(length)
    if length >= 0 and len(raw) != length:
        raise OnnxExternalDataError(
            f"initializer {name!r}: external-data file {location!r} is "
            f"short (wanted {length} bytes at offset {offset}, got "
            f"{len(raw)})")
    return raw


def _parse_tensor(buf: bytes, base_dir=None) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw = None
    floats: list[float] = []
    int64s: list[int] = []
    external: dict[str, str] = {}
    data_location = 0
    for field, wire, value in _iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(value)
        elif field == 2 and wire == 0:
            dtype_code = value
        elif field == 8 and wire == 2:
            name = value.decode()
        elif field == 9 and wire == 2:
            raw = value
        elif field == 13 and wire == 2:
            external.update(_parse_string_entries(value))
        elif field == 14 and wire == 0:
            data_location = value
        elif field == 4:
            if wire == 2:  # packed floats
                floats.extend(struct.unpack(f"<{len(value) // 4}f", value))
            elif wire == 5:
                floats.append(struct.unpack("<f", value)[0])
        elif field == 7:
            # int64_data varints are two's-complement: without the sign
            # decode, a -1 Reshape target parses as 2**64-1 and overflows
            # the np.int64 conversion below
            if wire == 2:
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    int64s.append(v - 2**64 if v >= 2**63 else v)
            elif wire == 0:
                int64s.append(value - 2**64 if value >= 2**63 else value)
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"unsupported ONNX dtype {dtype_code} for {name!r}")
    if data_location == 1:  # EXTERNAL
        raw = _read_external(name, external, base_dir)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif floats:
        arr = np.asarray(floats, dtype=np.float32)
    elif int64s:
        arr = np.asarray(int64s, dtype=np.int64)
    else:
        arr = np.zeros(0, dtype=dtype)
    if dims:
        arr = arr.reshape(dims)
    elif arr.size == 1:
        # empty dims == ONNX scalar (0-d): torch exports Gather indices
        # this way, and rank matters (Gather(shape, 0-d) -> 0-d, which a
        # following Unsqueeze turns into the (1,) Concat element)
        arr = arr.reshape(())
    return name, arr


def read_initializers(path: str | Path) -> dict[str, np.ndarray]:
    """All graph initializers of an ONNX model as {name: array}.

    External-data tensors resolve against the model's own directory."""
    path = Path(path)
    data = path.read_bytes()
    out: dict[str, np.ndarray] = {}
    for field, wire, value in _iter_fields(data):
        if field == 7 and wire == 2:  # ModelProto.graph
            for gfield, gwire, gvalue in _iter_fields(value):
                if gfield == 5 and gwire == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gvalue, base_dir=path.parent)
                    out[name] = arr
    return out
