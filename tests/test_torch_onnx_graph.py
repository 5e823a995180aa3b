"""The port's ONNX reader, parser, writer and executors against the JAX
package's (``waifu2x_tensorrt_tpu.models.onnx_reader`` / ``onnx_graph`` /
``onnx_build``), on the CPU at small widths (swin base_dim 32, depths
(2, 2, 2, 2, 2), 64-pixel probes; cunet at 76):

- ``read_graph`` gives the same nodes, attributes, initializers and graph
  IO on ``onnx_build`` artifacts (fused and decomposed LayerNorm, cunet
  1x and 2x), torch exports (``torch_mirror``: dynamic batch, Shape /
  Gather chains), their constant-folded, fp16-quantized and
  externalized rewrites; the port's writers emit the reference's bytes;
- ``run_graph`` (numpy ground truth) is the same within 1e-5 (its convs
  run through torch on the CPU, the JAX package's through XLA);
- ``run_graph_torch`` matches ``run_graph_jax`` in fp32 within 3e-5 on
  every artifact, and in bf16 within max(2 x the JAX package's own bf16
  error, 0.02) on both exporters' graphs;
- the executor's op edge cases (split sizes, negative axes, gather
  indices, pads, slices with negative steps, conv pads, ConvTranspose
  output padding, DepthToSpace DCR / CRD, GELU forms, pool guards, the
  parser's varint and proto3 corners) on the numpy and torch executors.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.models import onnx_build as jbuild
from waifu2x_tensorrt_tpu.models import onnx_graph as jgraph
from waifu2x_tensorrt_tpu.models import onnx_reader as jreader
from waifu2x_tensorrt_tpu_torch.models import onnx_build as pbuild
from waifu2x_tensorrt_tpu_torch.models import onnx_graph as pgraph
from waifu2x_tensorrt_tpu_torch.models import onnx_reader as preader

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_onnx_artifacts import (  # noqa: E402
    CUNET,
    DEPTHS,
    SWIN,
    cunet_state,
    make_artifacts,
    swin_state,
)
from torch_onnx_artifacts import probe as _probe  # noqa: E402


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return make_artifacts(tmp_path_factory.mktemp("onnx"))


NAMES = SWIN + CUNET


def _same_value(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", NAMES)
def test_read_graph_matches_reference(artifacts, name):
    got = pgraph.read_graph(artifacts[name])
    want = jgraph.read_graph(artifacts[name])
    assert (got.name, got.inputs, got.outputs, got.input_shapes,
            got.had_fp16) == (want.name, want.inputs, want.outputs,
                              want.input_shapes, want.had_fp16)
    assert len(got.nodes) == len(want.nodes)
    for g, w in zip(got.nodes, want.nodes):
        assert (g.op_type, g.inputs, g.outputs, g.name) == \
            (w.op_type, w.inputs, w.outputs, w.name)
        assert set(g.attrs) == set(w.attrs)
        for k in g.attrs:
            _same_value(g.attrs[k], w.attrs[k], f"{g.name}.{k}")
    assert list(got.initializers) == list(want.initializers)
    for k in got.initializers:
        _same_value(got.initializers[k], want.initializers[k], k)
    assert pgraph.summarize(got) == jgraph.summarize(want)
    inits = preader.read_initializers(artifacts[name])
    ref = jreader.read_initializers(artifacts[name])
    assert list(inits) == list(ref)
    for k in inits:
        _same_value(inits[k], ref[k], k)


def test_writers_emit_the_reference_bytes(artifacts, tmp_path):
    """build_swin_onnx / build_cunet_onnx / fold_model /
    quantize_initializers_fp16 / externalize_initializers of both
    packages write the same bytes."""
    state = swin_state(1)
    pairs = [(pbuild.build_swin_onnx(state, 2, (64, 64), tmp_path / "a.onnx",
                                     base_dim=32, depths=DEPTHS),
              jbuild.build_swin_onnx(state, 2, (64, 64), tmp_path / "b.onnx",
                                     base_dim=32, depths=DEPTHS))]
    cstate = cunet_state(2, 2)
    pairs.append((pbuild.build_cunet_onnx(cstate, 2, tmp_path / "c.onnx"),
                  jbuild.build_cunet_onnx(cstate, 2, tmp_path / "d.onnx")))
    src = artifacts["torch_swin"]
    pairs.append((pbuild.fold_model(src, tmp_path / "e.onnx"),
                  jbuild.fold_model(src, tmp_path / "f.onnx")))
    pairs.append((pbuild.quantize_initializers_fp16(src, tmp_path / "g.onnx"),
                  jbuild.quantize_initializers_fp16(src,
                                                    tmp_path / "h.onnx")))
    for sub in ("i", "j"):
        (tmp_path / sub).mkdir()
    a = pbuild.externalize_initializers(src, tmp_path / "i" / "x.onnx",
                                        threshold_bytes=1024)
    b = jbuild.externalize_initializers(src, tmp_path / "j" / "x.onnx",
                                        threshold_bytes=1024)
    pairs.append((a, b))
    pairs.append((a.parent / "x.onnx.data", b.parent / "x.onnx.data"))
    for a, b in pairs:
        assert Path(a).read_bytes() == Path(b).read_bytes(), a


@pytest.mark.parametrize("name", NAMES)
def test_run_graph_matches_reference(artifacts, name):
    x = _probe(artifacts[name])
    g = pgraph.read_graph(artifacts[name])
    got = pgraph.run_graph(g, {g.inputs[0]: x})[g.outputs[0]]
    jg = jgraph.read_graph(artifacts[name])
    want = jgraph.run_graph(jg, {jg.inputs[0]: x})[jg.outputs[0]]
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_run_graph_torch_matches_run_graph_jax(artifacts, name):
    """fp32 within atol 3e-5, with the weights as tensors
    (``graph_params``)."""
    x = _probe(artifacts[name])
    g = pgraph.read_graph(artifacts[name])
    jg = jgraph.read_graph(artifacts[name])
    params = {k: torch.from_numpy(np.array(v))
              for k, v in pgraph.graph_params(g).items()}
    got = pgraph.run_graph_torch(g, {g.inputs[0]: torch.from_numpy(x)},
                                 params=params)[g.outputs[0]]
    want = np.asarray(jgraph.run_graph_jax(
        jg, {jg.inputs[0]: jnp.asarray(x)})[jg.outputs[0]])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)


@pytest.mark.parametrize("name", ["torch_swin", "torch_cunet"])
def test_run_graph_torch_bf16_matches_run_graph_jax(artifacts, name):
    """bf16 (fp32 islands) within max(2 x the JAX executor's own bf16
    error, 0.02) of the JAX bf16 run, on both exporters' graphs (the
    other artifacts hold the same ops)."""
    x = _probe(artifacts[name])
    g = pgraph.read_graph(artifacts[name])
    jg = jgraph.read_graph(artifacts[name])
    want = pgraph.run_graph(g, {g.inputs[0]: x})[g.outputs[0]]
    p16 = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16)
           for k, v in pgraph.graph_params(g).items()}
    got16 = pgraph.run_graph_torch(
        g, {g.inputs[0]: torch.from_numpy(x).to(torch.bfloat16)},
        params=p16, compute_dtype=torch.bfloat16)[g.outputs[0]]
    assert got16.dtype == torch.bfloat16
    j16 = np.asarray(jgraph.run_graph_jax(
        jg, {jg.inputs[0]: jnp.asarray(x, jnp.bfloat16)},
        params={k: jnp.asarray(v, jnp.bfloat16)
                for k, v in jgraph.graph_params(jg).items()},
        compute_dtype=jnp.bfloat16)[jg.outputs[0]].astype(jnp.float32))
    tol = max(2 * float(np.abs(j16 - want).max()), 0.02)
    assert float(np.abs(got16.float().numpy() - j16).max()) <= tol


# -- op edge cases: single-node graphs on the three executors -------------


def _graph(mod, node, inputs, outputs, inits=None):
    n = mod.OnnxNode(node[0], list(node[1]), list(node[2]),
                     attrs=dict(node[3]))
    return mod.OnnxGraph("t", [n], dict(inits or {}), list(inputs),
                         list(outputs))


def _three_ways(node, feeds, outputs, inits=None, atol=1e-6):
    """The JAX package's numpy executor, the port's, and the port's torch
    executor (feeds as tensors) agree on a one-node graph."""
    names = list(feeds)
    want = jgraph.run_graph(_graph(jgraph, node, names, outputs, inits),
                            feeds)
    got = pgraph.run_graph(_graph(pgraph, node, names, outputs, inits),
                           feeds)
    tgot = pgraph.run_graph_torch(
        _graph(pgraph, node, names, outputs, inits),
        {k: torch.from_numpy(np.array(v)) for k, v in feeds.items()})
    for o in outputs:
        assert got[o].shape == want[o].shape, o
        np.testing.assert_allclose(got[o], want[o], atol=atol, rtol=0)
        t = tgot[o]
        t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        assert t.shape == want[o].shape, (o, t.shape, want[o].shape)
        np.testing.assert_allclose(t, want[o], atol=atol, rtol=0)
    return want


_R = np.random.default_rng(11)
_X4 = _R.standard_normal((1, 4, 6, 8)).astype(np.float32)
_W = _R.standard_normal((3, 4, 3, 3)).astype(np.float32)
_WT = _R.standard_normal((4, 3, 4, 4)).astype(np.float32)
_B3 = _R.standard_normal(3).astype(np.float32)
_I64 = np.int64

EDGE_CASES = {
    # opset <= 12 carries unequal split sizes as an attribute
    "split_attr_sizes": (("Split", ["x"], ["a", "b"],
                          {"axis": 1, "split": [1, 3]}), {"x": _X4}, {}),
    "split_input_sizes": (("Split", ["x", "s"], ["a", "b", "c"],
                           {"axis": 3}), {"x": _X4},
                          {"s": np.asarray([2, 5, 1], _I64)}),
    "split_equal": (("Split", ["x"], ["a", "b"], {"axis": 2}),
                    {"x": _X4}, {}),
    "unsqueeze_negative_axes": (("Unsqueeze", ["x", "ax"], ["y"], {}),
                                {"x": _R.standard_normal(3).astype(
                                    np.float32)},
                                {"ax": np.asarray([-1, -2], _I64)}),
    "squeeze_all": (("Squeeze", ["x"], ["y"], {}),
                    {"x": _X4[:, :1, :1]}, {}),
    "gather_negative_indices": (("Gather", ["x", "i"], ["y"], {"axis": 1}),
                                {"x": _X4},
                                {"i": np.asarray([[-1, 0], [2, -3]], _I64)}),
    "gather_scalar_index": (("Gather", ["x", "i"], ["y"], {"axis": 3}),
                            {"x": _X4}, {"i": np.asarray(5, _I64)}),
    "transpose_default_perm": (("Transpose", ["x"], ["y"], {}),
                               {"x": _X4}, {}),
    "reduce_mean_axes_input": (("ReduceMean", ["x", "ax"], ["y"],
                                {"keepdims": 0}), {"x": _X4},
                               {"ax": np.asarray([1, -1], _I64)}),
    "reduce_mean_all": (("ReduceMean", ["x"], ["y"], {}), {"x": _X4}, {}),
    "conv_asymmetric_pads": (("Conv", ["x", "w", "b"], ["y"],
                              {"pads": [0, 2, 1, 0], "strides": [2, 1]}),
                             {"x": _X4}, {"w": _W, "b": _B3}),
    "conv_same_upper": (("Conv", ["x", "w"], ["y"],
                         {"auto_pad": "SAME_UPPER", "strides": [2, 2]}),
                        {"x": _X4}, {"w": _W}),
    "conv_dilated_grouped": (("Conv", ["x", "w"], ["y"],
                              {"pads": [2, 2, 2, 2], "dilations": [2, 2],
                               "group": 2}),
                             {"x": _X4}, {"w": _R.standard_normal(
                                 (4, 2, 3, 3)).astype(np.float32)}),
    "conv_transpose_output_padding": (
        ("ConvTranspose", ["x", "w", "b"], ["y"],
         {"strides": [3, 3], "pads": [1, 1, 1, 1],
          "output_padding": [1, 2]}),
        {"x": _X4}, {"w": _WT, "b": _B3}),
    "conv_transpose_asymmetric_pads": (
        ("ConvTranspose", ["x", "w"], ["y"],
         {"strides": [2, 2], "pads": [3, 0, 1, 2]}),
        {"x": _X4}, {"w": _WT}),
    "depth_to_space_dcr": (("DepthToSpace", ["x"], ["y"], {"blocksize": 2}),
                           {"x": _X4}, {}),
    "depth_to_space_crd": (("DepthToSpace", ["x"], ["y"],
                            {"blocksize": 2, "mode": "CRD"}),
                           {"x": _X4}, {}),
    "space_to_depth": (("SpaceToDepth", ["x"], ["y"], {"blocksize": 2}),
                       {"x": _X4}, {}),
    "pad_constant_value": (("Pad", ["x", "p", "v"], ["y"], {}), {"x": _X4},
                           {"p": np.asarray([0, 0, 1, 2, 0, 1, 3, 0], _I64),
                            "v": np.asarray(1.5, np.float32)}),
    "pad_edge": (("Pad", ["x", "p"], ["y"], {"mode": "edge"}), {"x": _X4},
                 {"p": np.asarray([0, 0, 2, 1, 0, 0, 1, 3], _I64)}),
    "pad_reflect": (("Pad", ["x", "p"], ["y"], {"mode": "reflect"}),
                    {"x": _X4},
                    {"p": np.asarray([0, 0, 2, 1, 0, 0, 1, 3], _I64)}),
    "pad_negative_crops": (("Pad", ["x", "p"], ["y"], {}), {"x": _X4},
                           {"p": np.asarray([0, 0, -1, 2, 0, 0, 1, -3],
                                            _I64)}),
    "slice_negative_step": (("Slice", ["x", "s", "e", "a", "st"], ["y"], {}),
                            {"x": _X4},
                            {"s": np.asarray([-1, 6], _I64),
                             "e": np.asarray([-(2**63), 0], _I64),
                             "a": np.asarray([3, 2], _I64),
                             "st": np.asarray([-2, -1], _I64)}),
    "slice_to_int64_max": (("Slice", ["x", "s", "e", "a"], ["y"], {}),
                           {"x": _X4},
                           {"s": np.asarray([-3], _I64),
                            "e": np.asarray([2**63 - 1], _I64),
                            "a": np.asarray([3], _I64)}),
    "gelu_erf": (("Gelu", ["x"], ["y"], {}), {"x": _X4}, {}),
    "gelu_tanh": (("Gelu", ["x"], ["y"], {"approximate": "tanh"}),
                  {"x": _X4}, {}),
    "layer_norm_axis": (("LayerNormalization", ["x", "s", "b"], ["y"],
                         {"axis": -2, "epsilon": 1e-3}), {"x": _X4},
                        {"s": _R.standard_normal((6, 8)).astype(np.float32),
                         "b": _R.standard_normal(8).astype(np.float32)}),
    "gemm_transposes": (("Gemm", ["a", "b", "c"], ["y"],
                         {"transA": 1, "transB": 1, "alpha": 0.5,
                          "beta": 2.0}),
                        {"a": _R.standard_normal((5, 3)).astype(np.float32)},
                        {"b": _R.standard_normal((4, 5)).astype(np.float32),
                         "c": _R.standard_normal(4).astype(np.float32)}),
    "where_static_mask": (("Where", ["m", "x", "z"], ["y"], {}), {"x": _X4},
                          {"m": _X4 > 0, "z": np.asarray(0.0, np.float32)}),
    "expand": (("Expand", ["x", "s"], ["y"], {}),
               {"x": _X4[:, :1]}, {"s": np.asarray([2, 4, 1, 1], _I64)}),
    "clip_attrs": (("Clip", ["x"], ["y"], {"min": -0.5, "max": 0.25}),
                   {"x": _X4}, {}),
    "pow_scalar_exponent": (("Pow", ["x", "e"], ["y"], {}),
                            {"x": np.abs(_X4)},
                            {"e": np.asarray(1.5, np.float32)}),
    "pow_one_element_exponent": (("Pow", ["x", "e"], ["y"], {}),
                                 {"x": np.abs(_X4)},
                                 {"e": np.asarray([2.0], np.float32)}),
    "pow_vector_exponent": (("Pow", ["x", "e"], ["y"], {}),
                            {"x": np.abs(_X4)},
                            {"e": np.linspace(0.5, 2, 8).astype(
                                np.float32)}),
    "clip_one_element_bounds": (("Clip", ["x", "lo", "hi"], ["y"], {}),
                                {"x": _X4},
                                {"lo": np.asarray([-0.5], np.float32),
                                 "hi": np.asarray(0.75, np.float32)}),
    "leaky_relu_default_alpha": (("LeakyRelu", ["x"], ["y"], {}),
                                 {"x": _X4}, {}),
    "flatten": (("Flatten", ["x"], ["y"], {"axis": 2}), {"x": _X4}, {}),
    "shape_then_static": (("Shape", ["x"], ["y"], {}), {"x": _X4}, {}),
    "cast_to_int": (("Cast", ["x"], ["y"], {"to": 7}), {"x": _X4 * 4}, {}),
    "average_pool_non_overlapping": (
        ("AveragePool", ["x"], ["y"],
         {"kernel_shape": [2, 2], "strides": [3, 3]}),
        {"x": _R.standard_normal((1, 2, 6, 9)).astype(np.float32)}, {}),
    "global_average_pool": (("GlobalAveragePool", ["x"], ["y"], {}),
                            {"x": _X4}, {}),
    "softmax_axis": (("Softmax", ["x"], ["y"], {"axis": 1}), {"x": _X4}, {}),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_executor_edge_case(case):
    node, feeds, inits = EDGE_CASES[case]
    _three_ways(node, feeds, node[2], inits, atol=2e-5)


def test_average_pool_guards_raise_on_both_executors():
    """ONNX defaults strides to 1 (overlapping windows); pads and
    ceil_mode are refused, not averaged wrongly."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    for attrs in ({"kernel_shape": [3, 3]},
                  {"kernel_shape": [2, 2], "strides": [2, 2],
                   "pads": [1, 1, 1, 1]},
                  {"kernel_shape": [2, 2], "strides": [2, 2],
                   "ceil_mode": 1}):
        g = _graph(pgraph, ("AveragePool", ["x"], ["y"], attrs), ["x"],
                   ["y"])
        with pytest.raises(NotImplementedError):
            pgraph.run_graph(g, {"x": x})
        with pytest.raises(NotImplementedError):
            pgraph.run_graph_torch(g, {"x": torch.from_numpy(x)})


def test_conv_same_lower_is_refused():
    g = _graph(pgraph, ("Conv", ["x", "w"], ["y"],
                        {"auto_pad": "SAME_LOWER"}), ["x"], ["y"],
               {"w": _W})
    for run, x in ((pgraph.run_graph, _X4),
                   (pgraph.run_graph_torch, torch.from_numpy(_X4))):
        with pytest.raises(NotImplementedError, match="SAME_LOWER"):
            run(g, {"x": x})


def test_torch_executor_keeps_the_compute_dtype():
    """bf16 in, bf16 out through convs (no hard fp32 cast), fp32 inside
    the precise ops, and the ground truth stays fp32."""
    node = ("Conv", ["x", "w"], ["y"], {"pads": [1, 1, 1, 1]})
    g = _graph(pgraph, node, ["x"], ["y"], {"w": _W})
    y = pgraph.run_graph_torch(g, {"x": torch.from_numpy(_X4).bfloat16()},
                               compute_dtype=torch.bfloat16)["y"]
    assert y.dtype == torch.bfloat16
    assert pgraph.run_graph(g, {"x": _X4})["y"].dtype == np.float32
    sm = _graph(pgraph, ("Softmax", ["x"], ["y"], {"axis": -1}), ["x"],
                ["y"])
    x16 = torch.from_numpy(_X4).bfloat16()
    y = pgraph.run_graph_torch(sm, {"x": x16},
                               compute_dtype=torch.bfloat16)["y"]
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(
        y, torch.softmax(x16.float(), -1).bfloat16(), atol=0, rtol=0)


def test_constants_are_copied_once():
    """With a ``consts`` dict kept across calls, a static operand becomes
    a tensor once and is reused; a changed value is converted again."""
    node = ("Mul", ["x", "c"], ["y"], {})
    c = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0], np.float32)
    g = _graph(pgraph, node, ["x"], ["y"], {"c": c})
    consts = {}
    x = torch.from_numpy(_X4)
    pgraph.run_graph_torch(g, {"x": x}, consts=consts)
    (key, (_, t)), = consts.items()
    pgraph.run_graph_torch(g, {"x": x}, consts=consts)
    assert consts[key][1] is t
    g.initializers["c"] = c * 2
    y = pgraph.run_graph_torch(g, {"x": x}, consts=consts)["y"]
    torch.testing.assert_close(y, x * torch.from_numpy(c * 2))


def test_read_graph_rejects_non_onnx_files(tmp_path):
    """The port's parser refuses what the JAX one refuses, with its
    messages."""
    cases = {
        "empty.onnx": b"",
        "image.onnx": b"\x89PNG\r\n\x1a\n" + b"\x00" * 500,
        "garbage.onnx": bytes(range(256)) * 40,
        "truncated.onnx": b"\x3a\xff\xff\xff\xff\xff\xff",
        "cut_float.onnx": b"\x3a\x07\x0a\x05\x2a\x03\x15\x00\x00",
        "odd_floats.onnx": b"\x3a\x0b\x2a\x09\x08\x01\x4a\x05"
                           b"\x00\x00\x80\x3f\x00",
    }
    for name, data in cases.items():
        p = tmp_path / name
        p.write_bytes(data)
        with pytest.raises(ValueError) as got:
            pgraph.read_graph(p)
        with pytest.raises(ValueError) as want:
            jgraph.read_graph(p)
        assert str(got.value) == str(want.value)


def test_missing_external_data_is_named(artifacts, tmp_path):
    src = artifacts["torch_swin_external"]
    lonely = tmp_path / src.name
    lonely.write_bytes(src.read_bytes())  # no .data beside it
    with pytest.raises(preader.OnnxExternalDataError) as got:
        pgraph.read_graph(lonely)
    with pytest.raises(jreader.OnnxExternalDataError) as want:
        jgraph.read_graph(lonely)
    assert str(got.value) == str(want.value)


def test_parser_corners_match_reference():
    """Negative int64 varints (a -1 Reshape target) and proto3 zero
    scalars (omitted values recovered from the declared type)."""
    neg1 = bytes([0xFF] * 9 + [0x01])
    payload = neg1 + bytes([12])
    buf = (bytes([0x08, 0x02]) + bytes([0x10, 0x07])
           + bytes([0x3A, len(payload)]) + payload)
    name, arr = preader._parse_tensor(buf)
    assert arr.dtype == np.int64
    np.testing.assert_array_equal(arr, [-1, 12])
    np.testing.assert_array_equal(arr, jreader._parse_tensor(buf)[1])
    for buf in (bytes([0x0A, 0x04]) + b"axis" + bytes([0xA0, 0x01, 0x02]),
                bytes([0x0A, 0x03]) + b"min" + bytes([0xA0, 0x01, 0x01])):
        assert pgraph._parse_attribute(buf) == jgraph._parse_attribute(buf)
    assert pgraph._parse_attribute(
        bytes([0x0A, 0x04]) + b"axis" + bytes([0xA0, 0x01, 0x02])) == \
        ("axis", 0)
