"""ONNX graph parsing + execution (no ``onnx``/``onnxruntime`` packages).

The port's copy of ``waifu2x_tensorrt_tpu.models.onnx_graph``: the
reference hands its model artifacts to nvonnxparser and TensorRT executes
them (img2img_build.cpp:88); this module parses the protobuf wire format
itself (extending onnx_reader.py's initializer walker to the full
GraphProto) and executes the node list:

- ``read_graph(path)``    -> OnnxGraph (nodes, initializers, graph IO)
- ``run_graph(graph, feeds)`` -> executes the node list with numpy (convs
  and erf through torch on the CPU, in float32): the ground-truth
  executor that conversion verification and ``validate`` hold every other
  path against.
- ``run_graph_torch(graph, feeds, params=..., compute_dtype=...)`` -> the
  same node walk on torch tensors, on any device: a parsed release
  artifact executes on the GPU directly, independent of the hand-built
  modules. Values derived only from initializers and shapes still fold on
  the host with the numpy ops (shape vectors, slice indices, masks), so
  dynamic-shape exports that compute reshape targets from ``Shape`` run
  unchanged; ``params`` supplies chosen initializers as tensors (the
  weights, cast once by the caller).
- ``summarize(graph)``    -> op histogram + parameter count.

Executor notes: single-batch inference graphs (the reference's loader
requires 2 IO tensors x 4 dims, img2img_load.cpp:175-188). Ops execute in
the stored node order, which the ONNX spec requires to be topologically
sorted.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch.models.onnx_reader import (
    _DTYPES,
    OnnxExternalDataError,
    _iter_fields,
    _parse_tensor,
    _read_varint,
)

INT64_MAX = 2**63 - 1


def _signed(v: int) -> int:
    """Protobuf varints are two's-complement for negative int64."""
    return v - 2**64 if v >= 2**63 else v


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OnnxGraph:
    name: str
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[str]  # graph inputs that are NOT initializers (the feeds)
    outputs: list[str]
    # declared feed shapes from the input ValueInfos: name -> tuple with an
    # int per static dim, None per dynamic dim (dim_param / absent). Static
    # torch traces declare the exact export geometry here — the shape probe
    # reads it instead of guessing (onnx_backend._probe_candidates).
    input_shapes: dict[str, tuple] = dataclasses.field(default_factory=dict)
    # True when the artifact stored fp16 weights/casts that read_graph
    # normalized to fp32 (exact on the stored values; compute precision
    # remains governed by --precision, reference parity with TensorRT
    # building fp16/tf32 engines regardless of the artifact's storage
    # dtype, img2img_build.cpp:123-135)
    had_fp16: bool = False


def _parse_attribute(buf: bytes, base_dir=None) -> tuple[str, Any]:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9 (type tag 20 ignored: presence determines the kind)."""
    name = ""
    value: Any = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[str] = []
    type_code = 0  # AttributeProto.type (field 20): 1=FLOAT, 2=INT, ...
    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 2:
            name = v.decode()
        elif field == 2 and wire == 5:
            value = struct.unpack("<f", v)[0]
        elif field == 3 and wire == 0:
            value = _signed(v)
        elif field == 4 and wire == 2:
            value = v.decode(errors="surrogateescape")
        elif field == 5 and wire == 2:
            value = _parse_tensor(v, base_dir=base_dir)[1]
        elif field == 7:
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
            elif wire == 5:
                floats.append(struct.unpack("<f", v)[0])
        elif field == 8:
            if wire == 2:
                pos = 0
                while pos < len(v):
                    iv, pos = _read_varint(v, pos)
                    ints.append(_signed(iv))
            elif wire == 0:
                ints.append(_signed(v))
        elif field == 9 and wire == 2:
            strings.append(v.decode(errors="surrogateescape"))
        elif field == 20 and wire == 0:
            type_code = v
    if floats:
        value = floats
    elif ints:
        value = ints
    elif strings:
        value = strings
    if value is None:
        # proto3-toolchain writers omit zero-valued scalars entirely;
        # recover the implied zero from the declared type so Gather(axis=0)
        # does not become axis=None and Clip(min=0.0) does not silently
        # drop its lower clamp. (torch's C++ serializer writes zeros
        # explicitly, so in-family exports never hit this.)
        if type_code == 1:  # FLOAT
            value = 0.0
        elif type_code == 2:  # INT
            value = 0
    return name, value


def _parse_node(buf: bytes, base_dir=None) -> OnnxNode:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    node = OnnxNode(op_type="", inputs=[], outputs=[])
    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 2:
            node.inputs.append(v.decode())
        elif field == 2 and wire == 2:
            node.outputs.append(v.decode())
        elif field == 3 and wire == 2:
            node.name = v.decode()
        elif field == 4 and wire == 2:
            node.op_type = v.decode()
        elif field == 5 and wire == 2:
            k, val = _parse_attribute(v, base_dir=base_dir)
            node.attrs[k] = val
    return node


def _value_info_name(buf: bytes) -> str:
    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 2:
            return v.decode()
    return ""


def _value_info_shape(buf: bytes) -> tuple[str, Optional[tuple]]:
    """Parse a ValueInfoProto into (name, shape) where shape has an int per
    dim_value dim and None per dynamic dim (dim_param or empty Dimension);
    shape is None when no tensor shape is declared at all.

    Wire path: ValueInfoProto{name=1, type=2} -> TypeProto{tensor_type=1}
    -> Tensor{shape=2} -> TensorShapeProto{dim=1 repeated} ->
    Dimension{dim_value=1, dim_param=2}."""
    name = ""
    shape: Optional[tuple] = None
    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 2:
            name = v.decode()
        elif field == 2 and wire == 2:  # TypeProto
            for tf, tw, tv in _iter_fields(v):
                if tf != 1 or tw != 2:  # tensor_type
                    continue
                for sf, sw, sv in _iter_fields(tv):
                    if sf != 2 or sw != 2:  # TensorShapeProto
                        continue
                    dims: list[Optional[int]] = []
                    for df, dw, dv in _iter_fields(sv):
                        if df != 1 or dw != 2:  # Dimension
                            continue
                        dim: Optional[int] = None
                        for ef, ew, ev in _iter_fields(dv):
                            if ef == 1 and ew == 0:  # dim_value
                                dim = _signed(ev)
                        dims.append(dim)
                    shape = tuple(dims)
    return name, shape


def read_graph(path: str | Path) -> OnnxGraph:
    """Parse ModelProto.graph: node=1, name=2, initializer=5, input=11,
    output=12. Raises ValueError for files that are not a parseable
    ModelProto (truncated, corrupt, or some other format entirely) — the
    honest analogue of nvonnxparser's parse failure (img2img_build.cpp:88
    error path) instead of an empty graph or a leaked low-level error.

    External-data initializers (data_location=EXTERNAL) resolve against
    the model's own directory; an unresolvable one raises
    OnnxExternalDataError naming the missing sidecar file."""
    path = Path(path)
    base_dir = path.parent
    data = path.read_bytes()
    graph = OnnxGraph("", [], {}, [], [])
    try:
        for field, wire, value in _iter_fields(data):
            if field == 7 and wire == 2:  # ModelProto.graph
                raw_inputs: list[str] = []
                for gf, gw, gv in _iter_fields(value):
                    if gf == 1 and gw == 2:
                        graph.nodes.append(_parse_node(gv, base_dir))
                    elif gf == 2 and gw == 2:
                        graph.name = gv.decode()
                    elif gf == 5 and gw == 2:
                        name, arr = _parse_tensor(gv, base_dir)
                        graph.initializers[name] = arr
                    elif gf == 11 and gw == 2:
                        name, shape = _value_info_shape(gv)
                        raw_inputs.append(name)
                        if shape is not None:
                            graph.input_shapes[name] = shape
                    elif gf == 12 and gw == 2:
                        graph.outputs.append(_value_info_name(gv))
                graph.inputs = [
                    n for n in raw_inputs if n not in graph.initializers
                ]
                graph.input_shapes = {
                    n: s for n, s in graph.input_shapes.items()
                    if n in graph.inputs
                }
    except OnnxExternalDataError:
        # the model parsed fine — its DATA sidecar is what's missing;
        # surface the named error so triage tells the user to ship the
        # pair instead of claiming the .onnx itself is corrupt
        raise
    except (ValueError, IndexError, UnicodeDecodeError, struct.error,
            OverflowError) as e:
        raise ValueError(
            f"{path}: not a parseable ONNX ModelProto "
            f"(corrupt or truncated protobuf: {e})") from e
    if not graph.nodes or not graph.outputs:
        raise ValueError(
            f"{path}: no graph nodes/outputs found — not an ONNX "
            f"ModelProto (wrong file format?)")
    _normalize_fp16(graph)
    return graph


def _normalize_fp16(graph: OnnxGraph) -> None:
    """fp16-storage artifacts (half-precision initializers/constants, or
    Cast-to-fp16 nodes): upcast to fp32 in place. The upcast is EXACT on
    every stored value (fp16 ⊂ fp32); downstream compute precision stays
    whatever --precision selects, exactly as for an fp32 artifact — the
    same contract TensorRT applies when building an fp16 or tf32 engine
    from any artifact storage dtype (img2img_build.cpp:123-135). Without
    this, fp16 weights fail positional conversion (dtype-gated
    table/bias detection) and the numpy ground-truth executor computes
    at fp16, pushing verification past its tolerance (fp16-initializer
    artifacts end to end)."""
    for k, v in graph.initializers.items():
        if v.dtype == np.float16:
            graph.initializers[k] = v.astype(np.float32)
            graph.had_fp16 = True
    for node in graph.nodes:
        for ak, av in list(node.attrs.items()):
            if isinstance(av, np.ndarray) and av.dtype == np.float16:
                node.attrs[ak] = av.astype(np.float32)
                graph.had_fp16 = True
        if node.op_type == "Cast" and int(node.attrs.get("to", 0)) == 10:
            node.attrs["to"] = 1  # FLOAT16 -> FLOAT
            graph.had_fp16 = True


def summarize(graph: OnnxGraph) -> dict:
    """Topology fingerprint for arch diffs against the reconstruction."""
    ops: dict[str, int] = {}
    for n in graph.nodes:
        ops[n.op_type] = ops.get(n.op_type, 0) + 1
    n_params = int(sum(a.size for a in graph.initializers.values()))
    return {
        "inputs": list(graph.inputs),
        "outputs": list(graph.outputs),
        "n_nodes": len(graph.nodes),
        "op_histogram": dict(sorted(ops.items())),
        "n_initializers": len(graph.initializers),
        "n_parameters": n_params,
    }


# ---------------------------------------------------------------------------
# Executors
#
# ``_eval_node`` is the numpy ground truth; ``_eval_node_torch`` runs the
# same op set on torch tensors, op by op (torch's API is not numpy's:
# permute for transpose, split sizes for split indices, index_select for
# take, ...). Structural parameters — reshape targets, slice indices, pad
# widths, axes, split sizes, gather indices — must be STATIC (host numpy)
# values; ``run_graph_torch`` guarantees that by folding every node whose
# inputs are all static with the numpy ops and by resolving ``Shape`` from
# the tensor's (static) shape.
# ---------------------------------------------------------------------------

# ONNX TensorProto.DataType -> torch dtype (Cast on tensors)
_TORCH_DTYPES = {
    1: torch.float32,
    2: torch.uint8,
    3: torch.int8,
    6: torch.int32,
    7: torch.int64,
    9: torch.bool,
    10: torch.float16,
    11: torch.float64,
}


def _static(v, node: OnnxNode, what: str) -> np.ndarray:
    if not isinstance(v, (np.ndarray, np.generic)):
        raise NotImplementedError(
            f"{node.op_type} (node {node.name!r}): {what} is data-dependent "
            "(a tensor); only initializer/shape-derived values are supported")
    return np.asarray(v)


def _is_static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _conv_pads(x_hw, w_hw, attrs) -> list[int]:
    """[top, left, bottom, right] of an ONNX Conv (explicit pads or
    SAME_UPPER: the odd pad at the end of each dim)."""
    auto_pad = attrs.get("auto_pad", "NOTSET")
    if auto_pad == "SAME_LOWER":
        # the odd pad at the START of each dim; torch exporters emit
        # explicit pads, so this never fires for the supported families
        raise NotImplementedError(
            "Conv auto_pad=SAME_LOWER (asymmetric leading pad) is not "
            "supported; re-export with explicit pads")
    if auto_pad != "SAME_UPPER":
        return list(attrs.get("pads", [0, 0, 0, 0]))
    strides = attrs.get("strides", [1, 1])
    dil = attrs.get("dilations", [1, 1])
    before, after = [], []
    for n, k, s, d in zip(x_hw, w_hw, strides, dil):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        before.append(total // 2)
        after.append(total - total // 2)
    return before + after


def _conv_t(x, w, b, attrs):
    """ONNX Conv on NCHW torch tensors."""
    pads = _conv_pads(tuple(x.shape[-2:]), tuple(w.shape[-2:]), attrs)
    top, left, bottom, right = (int(p) for p in pads)
    if (top, left) != (bottom, right):
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    return F.conv2d(x, w, b, stride=tuple(attrs.get("strides", [1, 1])),
                    padding=(top, left),
                    dilation=tuple(attrs.get("dilations", [1, 1])),
                    groups=int(attrs.get("group", 1)))


def _conv_transpose_t(x, w, b, attrs):
    """ONNX ConvTranspose (weight (I, O, kH, kW)) on NCHW torch tensors.
    Output rows [pads_begin, full - pads_end + output_padding) of the full
    transposed convolution ((n - 1) * stride + k rows)."""
    if int(attrs.get("group", 1)) != 1:
        raise NotImplementedError("grouped ConvTranspose")
    strides = tuple(int(s) for s in attrs.get("strides", [1, 1]))
    top, left, bottom, right = (int(p) for p in
                                attrs.get("pads", [0, 0, 0, 0]))
    out_pad = tuple(int(p) for p in attrs.get("output_padding", [0, 0]))
    if ((top, left) == (bottom, right)
            and all(p < s for p, s in zip(out_pad, strides))):
        return F.conv_transpose2d(x, w, b, stride=strides,
                                  padding=(top, left),
                                  output_padding=out_pad)
    y = F.conv_transpose2d(x, w, None, stride=strides)
    full_h, full_w = y.shape[-2:]
    end_h = full_h - bottom + out_pad[0]
    end_w = full_w - right + out_pad[1]
    y = F.pad(y, (0, max(end_w - full_w, 0), 0, max(end_h - full_h, 0)))
    y = y[..., top:end_h, left:end_w]
    return y if b is None else y + b.reshape(1, -1, 1, 1)


def _np_through_torch(fn, x, w, attrs) -> np.ndarray:
    """Run a torch conv helper on float32 CPU copies of numpy arrays."""
    xt = torch.from_numpy(np.array(x, np.float32))
    wt = torch.from_numpy(np.array(w, np.float32))
    with torch.no_grad():
        return fn(xt, wt, None, attrs).numpy()


def _conv(x, w, b, attrs):
    """Numpy ground truth: float32, bias added in numpy."""
    y = _np_through_torch(_conv_t, x, w, attrs)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y


def _conv_transpose(x, w, b, attrs):
    y = _np_through_torch(_conv_transpose_t, x, w, attrs)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y


def _softmax(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


def _erf(x) -> np.ndarray:
    return torch.erf(torch.from_numpy(np.array(x, np.float32))).numpy()


def _permute(x, *perm):
    """numpy's transpose or torch's permute, by the array's type."""
    return x.transpose(perm) if isinstance(x, np.ndarray) else x.permute(perm)


def _depth_to_space(x, r, mode):
    """NCHW depth-to-space of a numpy array or a tensor."""
    b, c, h, w = x.shape
    co = c // (r * r)
    if mode == "CRD":  # torch.nn.PixelShuffle layout
        y = _permute(x.reshape(b, co, r, r, h, w), 0, 1, 4, 2, 5, 3)
    else:  # DCR (default)
        y = _permute(x.reshape(b, r, r, co, h, w), 0, 3, 4, 1, 5, 2)
    return y.reshape(b, co, h * r, w * r)


def _space_to_depth(x, r):
    b_, c_, h_, w_ = x.shape
    y = _permute(x.reshape(b_, c_, h_ // r, r, w_ // r, r), 0, 3, 5, 1, 2, 4)
    return y.reshape(b_, c_ * r * r, h_ // r, w_ // r)


def _gemm(a, b_, c, attrs):
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        b_ = b_.T
    y = alpha * (a @ b_)
    if c is not None:
        y = y + beta * c
    return y


def _slice_args(env, node, ndim):
    """Python slices of an ONNX Slice (starts/ends/axes/steps static)."""
    starts = _static(env[node.inputs[1]], node, "starts").astype(np.int64)
    ends = _static(env[node.inputs[2]], node, "ends").astype(np.int64)
    axes = (_static(env[node.inputs[3]], node, "axes").astype(np.int64)
            if len(node.inputs) > 3 and node.inputs[3]
            else np.arange(len(starts)))
    steps = (_static(env[node.inputs[4]], node, "steps").astype(np.int64)
             if len(node.inputs) > 4 and node.inputs[4]
             else np.ones(len(starts), np.int64))
    slices = [slice(None)] * ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        e_ = None if e >= INT64_MAX else int(e)
        slices[int(a)] = slice(int(s), e_, int(st))
    return slices


def _slice_t(x, slices):
    """torch has no negative-step slicing: clamp each slice on the host
    and flip what steps backwards."""
    flips = []
    for dim, sl in enumerate(slices):
        if sl.step is not None and sl.step < 0:
            idx = np.arange(x.shape[dim])[sl]
            slices[dim] = slice(0, 0) if idx.size == 0 else slice(
                int(idx[-1]), int(idx[0]) + 1, -int(sl.step))
            flips.append(dim)
    y = x[tuple(slices)]
    return y.flip(flips) if flips else y


def _pad_args(env, node, shape):
    """(crop slices or None, [(before, after)] widths, mode, cval)."""
    pads = _static(env[node.inputs[1]], node, "pads").astype(np.int64)
    mode = node.attrs.get("mode", "constant")
    cval = 0.0
    if len(node.inputs) > 2 and node.inputs[2]:
        cval = float(_static(env[node.inputs[2]], node, "constant value"))
    n = len(shape)
    before, after = pads[:n], pads[n:]
    crop = None
    if np.any(before < 0) or np.any(after < 0):  # negative pad == crop
        crop = tuple(
            slice(max(0, -int(b)), shape[i] - max(0, -int(a)))
            for i, (b, a) in enumerate(zip(before, after))
        )
        before = np.maximum(before, 0)
        after = np.maximum(after, 0)
    widths = list(zip(before.tolist(), after.tolist()))
    if mode not in ("constant", "edge", "reflect"):
        raise NotImplementedError(f"Pad mode {mode!r}")
    return crop, widths, mode, cval


def _pad(env, node):
    x = env[node.inputs[0]]
    crop, widths, mode, cval = _pad_args(env, node, x.shape)
    if crop is not None:
        x = x[crop]
    if mode == "constant":
        return np.pad(x, widths, mode="constant", constant_values=cval)
    return np.pad(x, widths, mode=mode)


def _pad_t(x, env, node):
    """ONNX Pad on a tensor. F.pad takes (last dim first) pairs; its
    'replicate' / 'reflect' modes pad only the trailing dims, which is
    where an image graph pads (a non-zero leading pad is refused)."""
    crop, widths, mode, cval = _pad_args(env, node, tuple(x.shape))
    if crop is not None:
        x = x[crop]
    flat = []
    for b, a in reversed(widths):
        flat += [b, a]
    if mode == "constant":
        return F.pad(x, flat, mode="constant", value=cval)
    padded = [i for i, w in enumerate(widths) if any(w)]
    if not padded:
        return x
    k = x.dim() - padded[0]  # the trailing dims that pad
    if k > 3:
        raise NotImplementedError(
            f"Pad mode {mode!r} over more than the last 3 dims")
    return F.pad(x, flat[:2 * k],
                 mode={"edge": "replicate", "reflect": "reflect"}[mode])


def _reduce_axes(env, node):
    axes = node.attrs.get("axes")
    if axes is None and len(node.inputs) > 1 and node.inputs[1]:
        axes = _static(env[node.inputs[1]], node,
                       "axes").astype(np.int64).tolist()
    keepdims = bool(node.attrs.get("keepdims", 1))
    return (tuple(int(a) for a in axes) if axes is not None else None,
            keepdims)


def _average_pool_args(node, shape):
    k = node.attrs["kernel_shape"]
    s = node.attrs.get("strides", [1] * len(k))  # ONNX default is 1
    if (any(node.attrs.get("pads", [])) or node.attrs.get("ceil_mode")
            or node.attrs.get("auto_pad", "NOTSET") != "NOTSET"
            or s[0] < k[0] or s[1] < k[1]):
        # raising beats silently wrong means (the executor is the fidelity
        # ground truth): the supported families only emit the unpadded
        # floor-mode non-overlapping form (cunet SE squeeze); the
        # stride-block reshape requires s >= k
        raise NotImplementedError(
            "AveragePool with pads/ceil_mode/auto_pad/overlapping windows")
    _b, _c, h_, w_ = shape
    return k, s, (h_ - k[0]) // s[0] + 1, (w_ - k[1]) // s[1] + 1


def _unsqueeze_axes(env, node, ndim):
    ins = node.inputs
    axes = (_static(env[ins[1]], node, "axes").astype(np.int64).tolist()
            if len(ins) > 1 else node.attrs["axes"])
    # spec: axes index the OUTPUT rank — normalize negatives against it
    # before inserting in ascending order
    out_rank = ndim + len(axes)
    return sorted(int(a) % out_rank for a in axes)


def _split_sizes(env, node, dim_len):
    ins = node.inputs
    if len(ins) > 1 and ins[1]:  # opset >= 13: sizes as an input
        return _static(env[ins[1]], node,
                       "split sizes").astype(np.int64).tolist()
    if node.attrs.get("split"):  # opset <= 12: sizes attribute
        return [int(s) for s in node.attrs["split"]]
    return [dim_len // len(node.outputs)] * len(node.outputs)


def _eval_node(node: OnnxNode, env: dict) -> None:
    """Execute one node into ``env`` with numpy (the ground truth)."""
    op = node.op_type
    ins = node.inputs

    def inp(i, default=None):
        if i >= len(ins) or not ins[i]:
            return default
        return env[ins[i]]

    x = inp(0)
    if op == "Conv":
        y = _conv(x, inp(1), inp(2), node.attrs)
    elif op == "ConvTranspose":
        y = _conv_transpose(x, inp(1), inp(2), node.attrs)
    elif op == "Gemm":
        y = _gemm(x, inp(1), inp(2), node.attrs)
    elif op == "MatMul":
        y = x @ inp(1)
    elif op == "Add":
        y = x + inp(1)
    elif op == "Sub":
        y = x - inp(1)
    elif op == "Mul":
        y = x * inp(1)
    elif op == "Div":
        y = x / inp(1)
    elif op == "Pow":
        y = x ** inp(1)
    elif op == "Sqrt":
        y = np.sqrt(x)
    elif op == "Exp":
        y = np.exp(x)
    elif op == "Neg":
        y = -x
    elif op == "Erf":
        y = _erf(x)
    elif op == "Relu":
        y = np.maximum(x, 0)
    elif op == "LeakyRelu":
        alpha = node.attrs.get("alpha", 0.01)
        y = np.where(x >= 0, x, alpha * x)
    elif op == "Sigmoid":
        y = 1.0 / (1.0 + np.exp(-x))
    elif op == "Tanh":
        y = np.tanh(x)
    elif op == "Clip":
        lo = inp(1) if len(ins) > 1 else node.attrs.get("min")
        hi = inp(2) if len(ins) > 2 else node.attrs.get("max")
        y = np.clip(x, lo, hi)
    elif op == "Softmax":
        y = _softmax(x, int(node.attrs.get("axis", -1)))
    elif op == "LayerNormalization":
        axis = int(node.attrs.get("axis", -1))
        eps = node.attrs.get("epsilon", 1e-5)
        axes = tuple(range(axis % x.ndim, x.ndim))
        mu = np.mean(x, axis=axes, keepdims=True, dtype=np.float32)
        var = np.mean((x - mu) ** 2, axis=axes, keepdims=True,
                      dtype=np.float32)
        y = (x - mu) / np.sqrt(var + eps)
        y = y * inp(1)
        if len(ins) > 2 and ins[2]:
            y = y + inp(2)
    elif op == "Reshape":
        shape = _static(env[ins[1]], node, "shape").astype(np.int64).tolist()
        shape = [x.shape[i] if s == 0 else int(s)
                 for i, s in enumerate(shape)]
        y = x.reshape(shape)
    elif op == "Transpose":
        y = np.transpose(x, node.attrs.get("perm"))
    elif op == "Concat":
        y = np.concatenate([env[i] for i in ins],
                           axis=int(node.attrs["axis"]))
    elif op == "Slice":
        y = x[tuple(_slice_args(env, node, x.ndim))]
    elif op == "Pad":
        y = _pad(env, node)
    elif op == "Gather":
        y = np.take(x, _static(inp(1), node, "indices").astype(np.int64),
                    axis=int(node.attrs.get("axis", 0)))
    elif op == "Unsqueeze":
        y = x
        for a in _unsqueeze_axes(env, node, x.ndim):
            y = np.expand_dims(y, a)
    elif op == "Squeeze":
        axes = (_static(env[ins[1]], node, "axes").astype(np.int64).tolist()
                if len(ins) > 1 and ins[1] else node.attrs.get("axes"))
        y = np.squeeze(x, axis=tuple(int(a) for a in axes)
                       if axes is not None else None)
    elif op == "Shape":
        y = np.asarray(x.shape, np.int64)
    elif op == "Expand":
        y = np.broadcast_to(
            x, np.broadcast_shapes(
                x.shape, tuple(_static(env[ins[1]], node,
                                       "shape").astype(np.int64))))
    elif op == "Cast":
        y = x.astype(_DTYPES[int(node.attrs["to"])])
    elif op == "ConstantOfShape":
        val = node.attrs.get("value")
        fill = val.reshape(-1)[0] if val is not None else np.float32(0)
        y = np.full(tuple(_static(env[ins[0]], node,
                                  "shape").astype(np.int64)), fill)
    elif op == "Constant":
        y = node.attrs["value"]
    elif op == "Identity":
        y = x
    elif op == "Flatten":
        axis = int(node.attrs.get("axis", 1))
        y = x.reshape(int(np.prod(x.shape[:axis], initial=1)), -1)
    elif op == "Split":
        axis = int(node.attrs.get("axis", 0))
        sizes = _split_sizes(env, node, x.shape[axis])
        parts = np.split(x, np.cumsum(sizes)[:-1].tolist(), axis=axis)
        for out_name, part in zip(node.outputs, parts):
            env[out_name] = np.asarray(part)
        return
    elif op == "Where":
        y = np.where(x, inp(1), inp(2))
    elif op == "ReduceMean":
        axes, keepdims = _reduce_axes(env, node)
        y = np.mean(x, axis=axes, keepdims=keepdims, dtype=np.float32)
    elif op == "GlobalAveragePool":
        y = np.mean(x, axis=(2, 3), keepdims=True, dtype=np.float32)
    elif op == "AveragePool":
        k, s, oh, ow = _average_pool_args(node, x.shape)
        b_, c_ = x.shape[:2]
        y = np.mean(
            x[:, :, : oh * s[0], : ow * s[1]]
            .reshape(b_, c_, oh, s[0], ow, s[1])[:, :, :, : k[0], :,
                                                 : k[1]],
            axis=(3, 5), dtype=np.float32)
    elif op == "DepthToSpace":
        y = _depth_to_space(x, int(node.attrs["blocksize"]),
                            node.attrs.get("mode", "DCR"))
    elif op == "SpaceToDepth":
        y = _space_to_depth(x, int(node.attrs["blocksize"]))
    elif op == "Gelu":
        if node.attrs.get("approximate", "none") == "tanh":
            y = 0.5 * x * (1.0 + np.tanh(
                np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))
        else:
            y = 0.5 * x * (1.0 + _erf(x / np.sqrt(2.0)))
    else:
        raise NotImplementedError(
            f"ONNX op {op!r} (node {node.name!r}) is not implemented")
    env[node.outputs[0]] = np.asarray(y)


def run_graph(
    graph: OnnxGraph, feeds: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """Execute the graph with numpy (ground truth); {output_name: array}."""
    env: dict[str, np.ndarray] = dict(graph.initializers)
    env.update({k: np.asarray(v) for k, v in feeds.items()})
    missing = [n for n in graph.inputs if n not in env]
    if missing:
        raise ValueError(f"missing graph inputs: {missing}")
    for node in graph.nodes:
        _eval_node(node, env)
    return {name: env[name] for name in graph.outputs}


def fold_constants(graph: OnnxGraph) -> int:
    """In-place onnxsim-style constant folding: evaluate every node whose
    inputs are all compile-time constants (initializers, Constant nodes,
    already-folded values — plus ``Shape`` of a graph input whose declared
    geometry is fully static) and replace it with initializers; prune
    initializers nothing references afterwards. Returns the number of
    nodes folded: the graph shape onnx-simplifier or the dynamo exporter
    hand over (Constant nodes promoted to initializers, the torch tracer's
    Shape/Gather/Unsqueeze/Concat chains collapsed to static Reshape
    targets)."""
    env: dict[str, np.ndarray] = dict(graph.initializers)
    static_inputs = {
        n: np.asarray(s, np.int64)
        for n, s in graph.input_shapes.items()
        if s is not None and all(d is not None for d in s)
    }
    kept: list[OnnxNode] = []
    folded = 0
    for node in graph.nodes:
        if (node.op_type == "Shape" and node.inputs
                and node.inputs[0] in static_inputs
                and not node.attrs):  # start/end attrs: keep general path
            env[node.outputs[0]] = static_inputs[node.inputs[0]]
            graph.initializers[node.outputs[0]] = env[node.outputs[0]]
            folded += 1
            continue
        if all(i in env or not i for i in node.inputs):
            try:
                _eval_node(node, env)
            except Exception:
                kept.append(node)  # un-foldable op: leave for runtime
                continue
            for out in node.outputs:
                graph.initializers[out] = env[out]
            folded += 1
            continue
        kept.append(node)
    graph.nodes = kept
    referenced = set(graph.outputs)
    for node in kept:
        referenced.update(node.inputs)
    graph.initializers = {
        k: v for k, v in graph.initializers.items() if k in referenced
    }
    return folded


# fp32 islands for reduced-precision graph execution: transcendentals and
# reductions run in f32 even when the rest of the graph runs bf16 (the
# same per-layer precision assignment TensorRT's fp16 builder applies to
# an fp32 ONNX graph — reference img2img_build.cpp:88 builds fp16 engines
# from fp32 artifacts without any Cast nodes in them).
_PRECISE_OPS = frozenset({
    "Softmax", "LayerNormalization", "Erf", "Gelu", "Pow", "Sqrt", "Exp",
    "Sigmoid", "Tanh", "ReduceMean", "GlobalAveragePool", "AveragePool",
})


def _tensor_of(name: str, v: np.ndarray, dtype, device, consts):
    """A static value as a tensor on ``device``: floats in ``dtype``
    (float32 when None), other types as they are. ``consts`` (a dict kept
    by the caller across calls) caches each conversion by (name, dtype,
    device), so a served graph copies its constants to the device once."""
    v = np.asarray(v)
    if v.dtype.kind == "f":
        dtype = dtype or torch.float32
    else:
        dtype = None
    key = (name, dtype, str(device))
    if consts is not None:
        hit = consts.get(key)
        if hit is not None and (hit[0] is v or (
                hit[0].shape == v.shape and hit[0].dtype == v.dtype
                and np.array_equal(hit[0], v))):
            return hit[1]
    t = torch.from_numpy(np.array(v)).to(device=device, dtype=dtype)
    if consts is not None:
        consts[key] = (v, t)
    return t


def _eval_node_torch(node: OnnxNode, env: dict, to, consts) -> None:
    """Execute one node whose inputs include a tensor into ``env``.

    ``to`` is the dtype every float input is cast to first (None: the
    inputs' own dtypes); static float inputs become tensors of that
    dtype. Structural inputs stay host numpy (``_static``)."""
    op = node.op_type
    ins = node.inputs
    device = next(env[i].device for i in ins
                  if i and isinstance(env[i], torch.Tensor))

    def inp(i, default=None):
        if i >= len(ins) or not ins[i]:
            return default
        v = env[ins[i]]
        if _is_static(v):
            return _tensor_of(ins[i], v, to, device, consts)
        if to is not None and v.is_floating_point() and v.dtype != to:
            return v.to(to)
        return v

    def scalar(i, default=None):
        """A static one-element operand (Clip bounds, Pow exponents) as a
        float; anything else as ``inp`` gives it."""
        if i >= len(ins) or not ins[i]:
            return default
        v = env[ins[i]]
        if _is_static(v) and np.size(v) == 1:
            return float(np.asarray(v).reshape(-1)[0])
        return inp(i)

    x = inp(0)
    if op == "Conv":
        y = _conv_t(x, inp(1), inp(2), node.attrs)
    elif op == "ConvTranspose":
        y = _conv_transpose_t(x, inp(1), inp(2), node.attrs)
    elif op == "Gemm":
        y = _gemm(x, inp(1), inp(2), node.attrs)
    elif op == "MatMul":
        y = torch.matmul(x, inp(1))
    elif op == "Add":
        y = x + inp(1)
    elif op == "Sub":
        y = x - inp(1)
    elif op == "Mul":
        y = x * inp(1)
    elif op == "Div":
        y = x / inp(1)
    elif op == "Pow":
        y = torch.pow(x, scalar(1))
    elif op == "Sqrt":
        y = torch.sqrt(x)
    elif op == "Exp":
        y = torch.exp(x)
    elif op == "Neg":
        y = -x
    elif op == "Erf":
        y = torch.erf(x)
    elif op == "Relu":
        y = torch.relu(x)
    elif op == "LeakyRelu":
        y = F.leaky_relu(x, float(node.attrs.get("alpha", 0.01)))
    elif op == "Sigmoid":
        y = torch.sigmoid(x)
    elif op == "Tanh":
        y = torch.tanh(x)
    elif op == "Clip":
        if len(ins) > 1:
            lo, hi = scalar(1), scalar(2)
        else:
            lo, hi = node.attrs.get("min"), node.attrs.get("max")
        y = torch.clamp(x, lo, hi)
    elif op == "Softmax":
        y = torch.softmax(x, int(node.attrs.get("axis", -1)))
    elif op == "LayerNormalization":
        axis = int(node.attrs.get("axis", -1)) % x.dim()
        y = F.layer_norm(x, tuple(x.shape[axis:]),
                         eps=float(node.attrs.get("epsilon", 1e-5)))
        y = y * inp(1)
        if len(ins) > 2 and ins[2]:
            y = y + inp(2)
    elif op == "Reshape":
        shape = _static(env[ins[1]], node, "shape").astype(np.int64).tolist()
        y = x.reshape([x.shape[i] if s == 0 else int(s)
                       for i, s in enumerate(shape)])
    elif op == "Transpose":
        perm = node.attrs.get("perm")
        y = x.permute(*(perm if perm is not None
                        else range(x.dim() - 1, -1, -1)))
    elif op == "Concat":
        y = torch.cat([inp(i) for i in range(len(ins))],
                      dim=int(node.attrs["axis"]))
    elif op == "Slice":
        y = _slice_t(x, _slice_args(env, node, x.dim()))
    elif op == "Pad":
        y = _pad_t(x, env, node)
    elif op == "Gather":
        axis = int(node.attrs.get("axis", 0)) % x.dim()
        idx = _static(env[ins[1]], node, "indices").astype(np.int64)
        flat = _tensor_of(ins[1], idx.reshape(-1) % x.shape[axis], None,
                          device, consts)
        y = torch.index_select(x, axis, flat).reshape(
            *x.shape[:axis], *idx.shape, *x.shape[axis + 1:])
    elif op == "Unsqueeze":
        y = x
        for a in _unsqueeze_axes(env, node, x.dim()):
            y = y.unsqueeze(a)
    elif op == "Squeeze":
        axes = (_static(env[ins[1]], node, "axes").astype(np.int64).tolist()
                if len(ins) > 1 and ins[1] else node.attrs.get("axes"))
        if axes is None:
            axes = [d for d, n in enumerate(x.shape) if n == 1]
        y = x
        for a in sorted((int(a) % x.dim() for a in axes), reverse=True):
            y = y.squeeze(a)
    elif op == "Shape":
        y = np.asarray(tuple(x.shape), np.int64)  # static
    elif op == "Expand":
        y = torch.broadcast_to(x, np.broadcast_shapes(
            tuple(x.shape), tuple(_static(env[ins[1]], node,
                                          "shape").astype(np.int64))))
    elif op == "Cast":
        y = x.to(_TORCH_DTYPES[int(node.attrs["to"])])
    elif op == "Identity":
        y = x
    elif op == "Flatten":
        axis = int(node.attrs.get("axis", 1))
        y = x.reshape(int(np.prod(x.shape[:axis], initial=1)), -1)
    elif op == "Split":
        axis = int(node.attrs.get("axis", 0))
        parts = torch.split(x, _split_sizes(env, node, x.shape[axis]),
                            dim=axis)
        for out_name, part in zip(node.outputs, parts):
            env[out_name] = part
        return
    elif op == "Where":
        y = torch.where(inp(0).to(torch.bool), inp(1), inp(2))
    elif op == "ReduceMean":
        axes, keepdims = _reduce_axes(env, node)
        y = x.mean(dim=axes if axes is not None else
                   tuple(range(x.dim())), keepdim=keepdims,
                   dtype=torch.float32)
    elif op == "GlobalAveragePool":
        y = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
    elif op == "AveragePool":
        k, s, oh, ow = _average_pool_args(node, tuple(x.shape))
        b_, c_ = x.shape[:2]
        y = (x[:, :, : oh * s[0], : ow * s[1]]
             .reshape(b_, c_, oh, s[0], ow, s[1])[:, :, :, : k[0], :,
                                                  : k[1]]
             .mean(dim=(3, 5), dtype=torch.float32))
    elif op == "DepthToSpace":
        y = _depth_to_space(x, int(node.attrs["blocksize"]),
                            node.attrs.get("mode", "DCR"))
    elif op == "SpaceToDepth":
        y = _space_to_depth(x, int(node.attrs["blocksize"]))
    elif op == "Gelu":
        y = F.gelu(x, approximate=node.attrs.get("approximate", "none"))
    else:
        raise NotImplementedError(
            f"ONNX op {op!r} (node {node.name!r}) is not implemented")
    env[node.outputs[0]] = y


def run_graph_torch(graph: OnnxGraph, feeds: dict,
                    params: Optional[dict] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    consts: Optional[dict] = None) -> dict:
    """Execute the graph on torch tensors (any device).

    ``feeds`` are tensors; initializers stay static host values unless
    listed in ``params`` (a {initializer_name: tensor} override, e.g. the
    weights on the device, cast once — see ``graph_params``). Nodes whose
    inputs are all static fold on the host with the numpy executor, so
    shape vectors / slice indices / masks never become tensors; static
    values that a tensor op consumes are copied to the device (once, when
    the caller keeps a ``consts`` dict across calls).

    ``compute_dtype`` (e.g. ``torch.bfloat16``) runs every tensor node at
    that dtype, except the ``_PRECISE_OPS`` fp32 islands, whose float
    inputs are upcast and whose outputs are cast back. Like the TensorRT
    fp16 builder, this overrides any dtypes the export itself encodes
    (explicit Cast nodes included); ``None`` runs the export's own fp32
    math.
    """
    env: dict = dict(graph.initializers)
    if params:
        unknown = [k for k in params if k not in graph.initializers]
        if unknown:
            raise ValueError(f"params override unknown initializers: "
                             f"{unknown[:5]}")
        env.update(params)
    env.update(feeds)
    missing = [n for n in graph.inputs if n not in env]
    if missing:
        raise ValueError(f"missing graph inputs: {missing}")

    for node in graph.nodes:
        if all(_is_static(env[i]) for i in node.inputs if i):
            _eval_node(node, env)  # host constant folding
            continue
        if compute_dtype is None:
            _eval_node_torch(node, env, None, consts)
            continue
        to = (torch.float32 if node.op_type in _PRECISE_OPS
              else compute_dtype)
        _eval_node_torch(node, env, to, consts)
        for out in node.outputs:
            v = env.get(out)
            if (isinstance(v, torch.Tensor) and v.is_floating_point()
                    and v.dtype != compute_dtype):
                env[out] = v.to(compute_dtype)
    return {name: env[name] for name in graph.outputs}


def graph_params(graph: OnnxGraph) -> dict[str, np.ndarray]:
    """The float tensor initializers — the values ``run_graph_torch``
    should take as weight tensors (everything else: shapes, indices,
    masks, scalar constants — stays static and folds)."""
    return {
        k: v for k, v in graph.initializers.items()
        if v.ndim >= 1 and v.dtype in (np.float32, np.float16, np.float64)
    }
