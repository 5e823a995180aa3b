"""ONNX model serialization + export-like graphs of the waifu2x models.

The port's copy of ``waifu2x_tensorrt_tpu.models.onnx_build`` (numpy only;
``tests/test_torch_onnx_graph.py`` pins its files to the reference's byte
for byte). ``build_cunet_onnx``/``build_swin_onnx`` serialize the upstream
architectures node-for-node the way a torch ONNX export lays them out
(NCHW, Conv/ConvTranspose, MatMul+Add linears, Slice crops, Slice+Concat
rolls, Erf-chain GELU, DepthToSpace CRD pixel-shuffle, LayerNormalization,
GlobalAveragePool SE). Load-time verification
(``onnx_backend.verify_swin_conversion``) re-exports converted weights
through them and executes both graphs with the numpy executor.

Initializer names follow the canonical torch module paths
(models/convert.py mapping tables), with Linear weights stored in torch's
(out, in) layout behind an explicit Transpose node — so
``cunet_from_onnx``/``swin_from_torch(read_initializers(...))`` convert
these files exactly as they would a release export.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from waifu2x_tensorrt_tpu_torch.models.swin_unet import (
    _relative_position_index,
)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Additive attention mask (nW, N, N) for cyclic-shifted windows: the
    standard Swin construction, windows straddling the roll boundary get
    -1e9 between tokens from different image regions. (The port's modules
    use analytic per-window shift flags instead; the export-like graph
    carries the mask as a constant, as a torch export does.)"""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for ws_ in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, ws_] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)  # (nW, N)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff == 0, 0.0, -1e9).astype(np.float32)


# --------------------------------------------------------------------------
# Minimal protobuf writer (inverse of onnx_reader/onnx_graph's walker)
# --------------------------------------------------------------------------

_NP_TO_ONNX = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
}


def _varint(v: int) -> bytes:
    if v < 0:
        v += 2**64  # two's complement int64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    out = b"".join(_int_field(1, int(d)) for d in arr.shape)
    out += _int_field(2, _NP_TO_ONNX[arr.dtype])
    out += _len_field(8, name.encode())
    out += _len_field(9, np.ascontiguousarray(arr).tobytes())
    return out


def _attr(name: str, value) -> bytes:
    out = _len_field(1, name.encode())
    if isinstance(value, float):
        out += _float_field(2, value) + _int_field(20, 1)  # FLOAT
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        out += _int_field(3, int(value)) + _int_field(20, 2)  # INT
    elif isinstance(value, str):
        out += _len_field(4, value.encode()) + _int_field(20, 3)  # STRING
    elif isinstance(value, np.ndarray):
        out += _len_field(5, tensor_proto("", value))
        out += _int_field(20, 4)  # TENSOR
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for v in value:
                out += _float_field(7, v)
            out += _int_field(20, 6)  # FLOATS
        else:
            for v in value:
                out += _int_field(8, int(v))
            out += _int_field(20, 7)  # INTS
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def node_proto(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
               name: str = "", **attrs) -> bytes:
    out = b"".join(_len_field(1, i.encode()) for i in inputs)
    out += b"".join(_len_field(2, o.encode()) for o in outputs)
    if name:
        out += _len_field(3, name.encode())
    out += _len_field(4, op_type.encode())
    for k, v in attrs.items():
        out += _len_field(5, _attr(k, v))
    return out


def _value_info(name: str) -> bytes:
    return _len_field(1, name.encode())


def write_model(
    nodes: Sequence[bytes],
    initializers: Mapping[str, np.ndarray],
    inputs: Sequence[str],
    outputs: Sequence[str],
    path: str | Path,
    graph_name: str = "waifu2x",
) -> Path:
    graph = b"".join(_len_field(1, n) for n in nodes)
    graph += _len_field(2, graph_name.encode())
    graph += b"".join(
        _len_field(5, tensor_proto(k, v)) for k, v in initializers.items()
    )
    graph += b"".join(_len_field(11, _value_info(i)) for i in inputs)
    graph += b"".join(_len_field(12, _value_info(o)) for o in outputs)
    model = _int_field(1, 8)  # ir_version
    model += _len_field(7, graph)
    # opset_import (ModelProto field 8): required by real ONNX tooling
    # (onnx.checker/onnxruntime reject files without one) — these
    # export-like artifacts must stay loadable outside this repo's own
    # parser. OperatorSetIdProto{domain=1 (default ai.onnx), version=2}.
    model += _len_field(8, _int_field(2, 17))
    path = Path(path)
    path.write_bytes(model)
    return path


# --------------------------------------------------------------------------
# Graph-building DSL
# --------------------------------------------------------------------------


class GraphBuilder:
    def __init__(self) -> None:
        self.nodes: list[bytes] = []
        self.inits: dict[str, np.ndarray] = {}
        self._n = 0

    def _name(self, op: str) -> str:
        self._n += 1
        return f"{op}_{self._n}"

    def init(self, name: str, arr: np.ndarray) -> str:
        self.inits[name] = np.asarray(arr)
        return name

    def const(self, arr: np.ndarray, name_hint: str = "c") -> str:
        return self.init(self._name(name_hint), arr)

    def emit(self, op: str, inputs: Sequence[str], n_out: int = 1,
             **attrs) -> str | list[str]:
        outs = [self._name(op.lower()) for _ in range(n_out)]
        self.nodes.append(node_proto(op, inputs, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    # -- common patterns ---------------------------------------------------
    def conv(self, x: str, prefix: str, state: Mapping[str, np.ndarray],
             pads=(0, 0, 0, 0), strides=(1, 1)) -> str:
        ins = [x, self.init(f"{prefix}.weight", state[f"{prefix}.weight"])]
        if f"{prefix}.bias" in state:
            ins.append(self.init(f"{prefix}.bias", state[f"{prefix}.bias"]))
        return self.emit("Conv", ins, pads=list(pads), strides=list(strides),
                         kernel_shape=list(state[f"{prefix}.weight"].shape[2:]))

    def conv_transpose(self, x: str, prefix: str,
                       state: Mapping[str, np.ndarray],
                       pads=(0, 0, 0, 0), strides=(2, 2)) -> str:
        ins = [x, self.init(f"{prefix}.weight", state[f"{prefix}.weight"])]
        if f"{prefix}.bias" in state:
            ins.append(self.init(f"{prefix}.bias", state[f"{prefix}.bias"]))
        return self.emit("ConvTranspose", ins, pads=list(pads),
                         strides=list(strides))

    def lrelu(self, x: str, alpha: float = 0.1) -> str:
        return self.emit("LeakyRelu", [x], alpha=alpha)

    def linear(self, x: str, prefix: str,
               state: Mapping[str, np.ndarray]) -> str:
        """torch nn.Linear as MatMul(x, W^T) + bias, with the initializer
        kept in torch's (out, in) layout under its module-path name."""
        w = self.init(f"{prefix}.weight", state[f"{prefix}.weight"])
        wt = self.emit("Transpose", [w], perm=[1, 0])
        y = self.emit("MatMul", [x, wt])
        if f"{prefix}.bias" in state:
            b = self.init(f"{prefix}.bias", state[f"{prefix}.bias"])
            y = self.emit("Add", [y, b])
        return y

    def crop2d(self, x: str, p: int) -> str:
        """Center crop by p on each spatial side of NCHW (torch
        F.pad(x, (-p,)*4), exported as Slice)."""
        starts = self.const(np.asarray([p, p], np.int64), "starts")
        ends = self.const(np.asarray([-p, -p], np.int64), "ends")
        axes = self.const(np.asarray([2, 3], np.int64), "axes")
        return self.emit("Slice", [x, starts, ends, axes])

    def add(self, a: str, b: str) -> str:
        return self.emit("Add", [a, b])

    def reshape(self, x: str, shape) -> str:
        s = self.const(np.asarray(shape, np.int64), "shape")
        return self.emit("Reshape", [x, s])

    def transpose(self, x: str, perm) -> str:
        return self.emit("Transpose", [x], perm=list(perm))

    def roll2d(self, x: str, shift: int, hw_axes=(1, 2)) -> str:
        """torch.roll over two spatial axes as Slice+Concat per axis (how
        the exporter lowers roll): roll(x, s) == concat(x[-s:], x[:-s])
        for either sign of s."""
        y = x
        for axis in hw_axes:
            ax = self.const(np.asarray([axis], np.int64), "axes")
            head = self.emit("Slice", [
                y, self.const(np.asarray([-shift], np.int64), "starts"),
                self.const(np.asarray([2**63 - 1], np.int64), "ends"), ax])
            tail = self.emit("Slice", [
                y, self.const(np.asarray([0], np.int64), "starts"),
                self.const(np.asarray([-shift], np.int64), "ends"), ax])
            y = self.emit("Concat", [head, tail], axis=axis)
        return y

    def gelu_erf(self, x: str) -> str:
        """torch nn.GELU (exact) as the exporter's Div/Erf/Add/Mul chain."""
        sqrt2 = self.const(np.float32(np.sqrt(2.0)), "sqrt2")
        one = self.const(np.float32(1.0), "one")
        half = self.const(np.float32(0.5), "half")
        e = self.emit("Erf", [self.emit("Div", [x, sqrt2])])
        return self.emit(
            "Mul", [self.emit("Mul", [x, half]), self.emit("Add", [e, one])])


# --------------------------------------------------------------------------
# CUNet / UpCUNet export-like graph (upstream nunif cunet; models/cunet.py)
# --------------------------------------------------------------------------


def _unet_conv(g: GraphBuilder, x: str, prefix: str, state, se: bool) -> str:
    x = g.lrelu(g.conv(x, f"{prefix}.conv.0", state))
    x = g.lrelu(g.conv(x, f"{prefix}.conv.2", state))
    if se:
        z = g.emit("GlobalAveragePool", [x])
        z = g.emit("Relu", [g.conv(z, f"{prefix}.conv.4.conv1", state)])
        z = g.emit("Sigmoid", [g.conv(z, f"{prefix}.conv.4.conv2", state)])
        x = g.emit("Mul", [x, z])
    return x


def _unet1(g: GraphBuilder, x: str, prefix: str, state, deconv: bool) -> str:
    x1 = _unet_conv(g, x, f"{prefix}.conv1", state, se=False)
    x2 = g.lrelu(g.conv(x1, f"{prefix}.conv1_down", state, strides=(2, 2)))
    x2 = _unet_conv(g, x2, f"{prefix}.conv2", state, se=True)
    x2 = g.lrelu(g.conv_transpose(x2, f"{prefix}.conv2_up", state))
    x3 = g.lrelu(g.conv(g.add(g.crop2d(x1, 4), x2), f"{prefix}.conv3", state))
    if deconv:
        return g.conv_transpose(x3, f"{prefix}.conv_bottom", state,
                                pads=(3, 3, 3, 3))
    return g.conv(x3, f"{prefix}.conv_bottom", state)


def _unet2(g: GraphBuilder, x: str, prefix: str, state) -> str:
    x1 = _unet_conv(g, x, f"{prefix}.conv1", state, se=False)
    x2 = g.lrelu(g.conv(x1, f"{prefix}.conv1_down", state, strides=(2, 2)))
    x2 = _unet_conv(g, x2, f"{prefix}.conv2", state, se=True)
    x3 = g.lrelu(g.conv(x2, f"{prefix}.conv2_down", state, strides=(2, 2)))
    x3 = _unet_conv(g, x3, f"{prefix}.conv3", state, se=True)
    x3 = g.lrelu(g.conv_transpose(x3, f"{prefix}.conv3_up", state))
    x4 = _unet_conv(g, g.add(g.crop2d(x2, 4), x3), f"{prefix}.conv4", state,
                    se=True)
    x4 = g.lrelu(g.conv_transpose(x4, f"{prefix}.conv4_up", state))
    x5 = g.lrelu(g.conv(g.add(g.crop2d(x1, 16), x4), f"{prefix}.conv5",
                        state))
    return g.conv(x5, f"{prefix}.conv_bottom", state)


def build_cunet_onnx(state: Mapping[str, np.ndarray], scale: int,
                     path: str | Path) -> Path:
    """Serialize the CUNet (1x) / UpCUNet (2x) graph with the given torch
    state_dict arrays; input 'x' NCHW float [0,1], output 'y'."""
    g = GraphBuilder()
    z1 = _unet1(g, "x", "unet1", state, deconv=(scale == 2))
    z2 = _unet2(g, z1, "unet2", state)
    z = g.add(g.crop2d(z1, 20), z2)
    lo = g.const(np.float32(0.0), "lo")
    hi = g.const(np.float32(1.0), "hi")
    y = g.emit("Clip", [z, lo, hi])
    g.nodes.append(node_proto("Identity", [y], ["y"]))
    return write_model(g.nodes, g.inits, ["x"], ["y"], path,
                       graph_name=f"cunet_{scale}x")


# --------------------------------------------------------------------------
# SwinUNet export-like graph (upstream nunif swin_unet; models/swin_unet.py)
# --------------------------------------------------------------------------


def _ln(g: GraphBuilder, x: str, prefix: str, state,
        decomposed: bool = False) -> str:
    """LayerNorm over the last axis: the fused opset>=17 node, or the
    pre-opset-17 decomposed chain (ReduceMean/Sub/Pow/ReduceMean/Add/
    Sqrt/Div/Mul/Add — what older torch exporters emit)."""
    ln_w = g.init(f"{prefix}.weight", state[f"{prefix}.weight"])
    ln_b = g.init(f"{prefix}.bias", state[f"{prefix}.bias"])
    if not decomposed:
        return g.emit("LayerNormalization", [x, ln_w, ln_b], axis=-1,
                      epsilon=1e-5)
    mu = g.emit("ReduceMean", [x], axes=[-1], keepdims=1)
    d = g.emit("Sub", [x, mu])
    two = g.const(np.float32(2.0), "two")
    var = g.emit("ReduceMean", [g.emit("Pow", [d, two])], axes=[-1],
                 keepdims=1)
    eps = g.const(np.float32(1e-5), "eps")
    std = g.emit("Sqrt", [g.add(var, eps)])
    y = g.emit("Mul", [g.emit("Div", [d, std]), ln_w])
    return g.add(y, ln_b)


def _swin_block(g: GraphBuilder, x: str, prefix: str, state,
                h: int, w: int, dim: int, heads: int, shift: int,
                mlp_ratio: int = 2, ws: int = 8,
                decomposed_ln: bool = False) -> str:
    """One pre-norm Swin block on NHWC tokens x: (1, h, w, dim)."""
    n_tok = ws * ws
    hd = dim // heads
    nw = (h // ws) * (w // ws)

    y = _ln(g, x, f"{prefix}.norm1", state, decomposed_ln)

    if shift:
        y = g.roll2d(y, -shift, hw_axes=(1, 2))
    # window partition: (1,h,w,c) -> (nW, N, c)
    y = g.reshape(y, (1, h // ws, ws, w // ws, ws, dim))
    y = g.transpose(y, (0, 1, 3, 2, 4, 5))
    y = g.reshape(y, (nw, n_tok, dim))

    qkv = g.linear(y, f"{prefix}.attn.qkv", state)  # (nW, N, 3c)
    qkv = g.reshape(qkv, (nw, n_tok, 3, heads, hd))
    qkv = g.transpose(qkv, (2, 0, 3, 1, 4))  # (3, nW, nh, N, hd)
    q, k, v = g.emit("Split", [qkv], n_out=3, axis=0)
    sq = g.const(np.asarray([0], np.int64), "axes")
    q = g.emit("Squeeze", [q, sq])
    k = g.emit("Squeeze", [k, sq])
    v = g.emit("Squeeze", [v, sq])

    scale_c = g.const(np.float32(hd ** -0.5), "scale")
    q = g.emit("Mul", [q, scale_c])
    attn = g.emit("MatMul", [q, g.transpose(k, (0, 1, 3, 2))])

    table = g.init(f"{prefix}.attn.relative_position_bias_table",
                   state[f"{prefix}.attn.relative_position_bias_table"])
    idx = g.const(_relative_position_index(ws).reshape(-1).astype(np.int64),
                  "rel_idx")
    bias = g.emit("Gather", [table, idx], axis=0)  # (N*N, nh)
    bias = g.transpose(g.reshape(bias, (n_tok, n_tok, heads)), (2, 0, 1))
    attn = g.add(attn, bias)

    if shift:
        mask = _shift_attn_mask(h, w, ws, shift)[:, None, :, :]
        attn = g.add(attn, g.const(mask.astype(np.float32), "shift_mask"))

    attn = g.emit("Softmax", [attn], axis=-1)
    out = g.emit("MatMul", [attn, v])  # (nW, nh, N, hd)
    out = g.reshape(g.transpose(out, (0, 2, 1, 3)), (nw, n_tok, dim))
    out = g.linear(out, f"{prefix}.attn.proj", state)

    # window merge back to (1, h, w, c)
    out = g.reshape(out, (1, h // ws, w // ws, ws, ws, dim))
    out = g.transpose(out, (0, 1, 3, 2, 4, 5))
    out = g.reshape(out, (1, h, w, dim))
    if shift:
        out = g.roll2d(out, shift, hw_axes=(1, 2))
    x = g.add(x, out)

    y = _ln(g, x, f"{prefix}.norm2", state, decomposed_ln)
    y = g.gelu_erf(g.linear(y, f"{prefix}.mlp_fc1", state))
    y = g.linear(y, f"{prefix}.mlp_fc2", state)
    return g.add(x, y)


def _swin_stage(g, x, stage, state, h, w, dim, heads, depth, ws=8,
                decomposed_ln=False):
    for i in range(depth):
        x = _swin_block(g, x, f"{stage}.block{i}", state, h, w, dim, heads,
                        shift=0 if i % 2 == 0 else ws // 2, ws=ws,
                        decomposed_ln=decomposed_ln)
    return x


def build_swin_onnx(state: Mapping[str, np.ndarray], scale: int,
                    hw: tuple[int, int], path: str | Path,
                    base_dim: int = 96,
                    depths: tuple = (2, 2, 6, 2, 2),
                    decomposed_ln: bool = False) -> Path:
    """Serialize the SwinUNet graph (static input (1,3,h,w), h,w % 32 == 0)
    with the given torch state_dict arrays; input 'x', output 'y'."""
    h, w = hw
    assert h % 32 == 0 and w % 32 == 0, "builder requires /32 geometry"
    c = base_dim
    half = c // 2
    g = GraphBuilder()

    s = g.lrelu(g.conv("x", "patch_conv1", state, pads=(1, 1, 1, 1)))
    s = g.lrelu(g.conv(s, "patch_conv2", state, pads=(1, 1, 1, 1)))

    e1 = g.conv(s, "down1", state, strides=(2, 2))
    e1 = g.transpose(e1, (0, 2, 3, 1))  # NHWC tokens
    e1 = _swin_stage(g, e1, "swin1", state, h // 2, w // 2, c,
                     max(c // 32, 1), depths[0],
                     decomposed_ln=decomposed_ln)

    e2 = g.conv(g.transpose(e1, (0, 3, 1, 2)), "down2", state,
                strides=(2, 2))
    e2 = g.transpose(e2, (0, 2, 3, 1))
    e2 = _swin_stage(g, e2, "swin2", state, h // 4, w // 4, 2 * c,
                     max((2 * c) // 32, 1), depths[2],
                     decomposed_ln=decomposed_ln)

    d2 = g.linear(e2, "up2", state)  # (1, h/4, w/4, 4c)
    d2 = g.emit("DepthToSpace", [g.transpose(d2, (0, 3, 1, 2))],
                blocksize=2, mode="CRD")
    d2 = g.add(g.transpose(d2, (0, 2, 3, 1)), e1)
    d2 = _swin_stage(g, d2, "swin3", state, h // 2, w // 2, c,
                     max(c // 32, 1), depths[3],
                     decomposed_ln=decomposed_ln)

    d1 = g.linear(d2, "up1", state)  # (1, h/2, w/2, 4*half)
    d1 = g.emit("DepthToSpace", [g.transpose(d1, (0, 3, 1, 2))],
                blocksize=2, mode="CRD")
    d1 = g.add(d1, s)  # both NCHW: pixel-shuffled decoder + stem skip

    z = g.conv(d1, "to_image", state, pads=(1, 1, 1, 1))
    if scale > 1:
        z = g.emit("DepthToSpace", [z], blocksize=scale, mode="CRD")
    lo = g.const(np.float32(0.0), "lo")
    hi = g.const(np.float32(1.0), "hi")
    y = g.emit("Clip", [z, lo, hi])
    g.nodes.append(node_proto("Identity", [y], ["y"]))
    return write_model(g.nodes, g.inits, ["x"], ["y"], path,
                       graph_name=f"swin_unet_{scale}x")


# --------------------------------------------------------------------------
# External-data and fp16 rewriters, constant folding
# --------------------------------------------------------------------------


def external_tensor_proto(name: str, arr: np.ndarray, location: str,
                          offset: int, length: int) -> bytes:
    """TensorProto with data_location=EXTERNAL: dims/dtype/name stay
    inline, the payload lives at [offset, offset+length) of ``location``
    (the onnx spec's StringStringEntryProto external_data entries)."""
    arr = np.asarray(arr)
    out = b"".join(_int_field(1, int(d)) for d in arr.shape)
    out += _int_field(2, _NP_TO_ONNX[arr.dtype])
    out += _len_field(8, name.encode())
    for k, v in (("location", location), ("offset", str(offset)),
                 ("length", str(length))):
        entry = _len_field(1, k.encode()) + _len_field(2, v.encode())
        out += _len_field(13, entry)
    out += _int_field(14, 1)  # data_location = EXTERNAL
    return out


def _reencode(field: int, wire: int, value) -> bytes:
    """Re-emit one parsed protobuf field verbatim (the parser's canonical
    varints round-trip exactly)."""
    if wire == 0:
        return _int_field(field, value)
    if wire == 2:
        return _len_field(field, value)
    if wire in (1, 5):
        return _tag(field, wire) + value
    raise ValueError(f"unsupported wire type {wire}")


def externalize_initializers(src: str | Path, dst: str | Path,
                             location: str | None = None,
                             threshold_bytes: int = 0,
                             align: int = 64) -> Path:
    """Rewrite ``src`` so every initializer >= ``threshold_bytes`` moves
    into one external-data sidecar file next to ``dst`` — the layout
    ``onnx.save_model(..., save_as_external_data=True)`` and torch's
    >2 GB exports produce. Used to rehearse the acceptance path on
    external-data artifacts without the onnx package. Every
    non-initializer byte of the model round-trips
    verbatim."""
    from waifu2x_tensorrt_tpu_torch.models.onnx_reader import (
        _iter_fields,
        _parse_tensor,
    )

    src, dst = Path(src), Path(dst)
    location = location or (dst.name + ".data")
    blob = bytearray()

    def _extern(tbuf: bytes) -> bytes:
        name, arr = _parse_tensor(tbuf, base_dir=src.parent)
        payload = np.ascontiguousarray(arr).tobytes()
        if len(payload) < threshold_bytes:
            return _len_field(5, tbuf)
        if align > 1 and len(blob) % align:
            blob.extend(b"\0" * (align - len(blob) % align))
        offset = len(blob)
        blob.extend(payload)
        return _len_field(5, external_tensor_proto(
            name, arr, location, offset, len(payload)))

    out = bytearray()
    for field, wire, value in _iter_fields(src.read_bytes()):
        if field == 7 and wire == 2:  # ModelProto.graph
            graph = bytearray()
            for gf, gw, gv in _iter_fields(value):
                if gf == 5 and gw == 2:  # GraphProto.initializer
                    graph += _extern(gv)
                else:
                    graph += _reencode(gf, gw, gv)
            out += _len_field(7, bytes(graph))
        else:
            out += _reencode(field, wire, value)
    dst.write_bytes(bytes(out))
    (dst.parent / location).write_bytes(bytes(blob))
    return dst


def quantize_initializers_fp16(src: str | Path, dst: str | Path) -> Path:
    """Rewrite ``src`` with every float32 initializer stored as float16 —
    the layout a ``model.half()`` torch export (or an onnxconverter
    float16 pass) produces. Values round to the nearest half; every other
    byte of the model round-trips verbatim. Rehearses the fp16-artifact
    acceptance path."""
    from waifu2x_tensorrt_tpu_torch.models.onnx_reader import (
        _iter_fields,
        _parse_tensor,
    )

    src, dst = Path(src), Path(dst)

    def _half(tbuf: bytes) -> bytes:
        name, arr = _parse_tensor(tbuf, base_dir=src.parent)
        if arr.dtype == np.float32:
            arr = arr.astype(np.float16)
        return _len_field(5, tensor_proto(name, arr))

    out = bytearray()
    for field, wire, value in _iter_fields(src.read_bytes()):
        if field == 7 and wire == 2:
            graph = bytearray()
            for gf, gw, gv in _iter_fields(value):
                if gf == 5 and gw == 2:
                    graph += _half(gv)
                else:
                    graph += _reencode(gf, gw, gv)
            out += _len_field(7, bytes(graph))
        else:
            out += _reencode(field, wire, value)
    dst.write_bytes(bytes(out))
    return dst


def fold_model(src: str | Path, dst: str | Path) -> Path:
    """Constant-fold ``src`` (onnx_graph.fold_constants) and re-serialize
    — producing the graph layout onnx-simplifier or the dynamo exporter
    would hand us from the same model: Constant nodes promoted to
    initializers, static shape chains collapsed, folded arithmetic.
    The dynamo exporter needs onnxscript, so this rewriter is how its
    graph idioms are rehearsed against the acceptance path."""
    from waifu2x_tensorrt_tpu_torch.models.onnx_graph import (
        fold_constants,
        read_graph,
    )

    graph = read_graph(src)
    fold_constants(graph)
    nodes = [
        node_proto(n.op_type, n.inputs, n.outputs, name=n.name, **n.attrs)
        for n in graph.nodes
    ]
    return write_model(nodes, graph.initializers, graph.inputs,
                       graph.outputs, dst, graph_name=graph.name or "folded")
