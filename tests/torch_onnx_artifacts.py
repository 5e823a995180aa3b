"""Small ONNX artifacts for the port's ONNX tests (``test_torch_onnx_*``,
``test_torch_build.py``): seeded, numpy- and torch-made, at small widths
(swin base_dim 32, depths (2, 2, 2, 2, 2); cunet upstream width, 76-pixel
probes)."""

import sys
from pathlib import Path

import numpy as np

from waifu2x_tensorrt_tpu_torch.models import convert, registry
from waifu2x_tensorrt_tpu_torch.models import onnx_build as pbuild
from waifu2x_tensorrt_tpu_torch.models import onnx_graph as pgraph

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mirror import export_torch_cunet, export_torch_swin  # noqa: E402

DEPTHS = (2, 2, 2, 2, 2)
SWIN = ["build_swin", "build_swin_decomposed_ln", "torch_swin",
        "torch_swin_folded", "torch_swin_fp16", "torch_swin_external"]
CUNET = ["build_cunet1", "build_cunet2", "torch_cunet"]


def swin_state(seed):
    """torch-layout state of a seeded base_dim-32 swin (2x), its bias
    tables scaled up so that a transposed table would show."""
    module, _ = registry.create_model("swin_unet/art", 2, -1, base_dim=32,
                                      depths=DEPTHS)
    flat = registry.init_params(module, seed=seed)
    flat = {k: v * 10 if "relative_position" in k else v
            for k, v in flat.items()}
    return convert.state_from_flax(flat, convert.swin_mapping(2, DEPTHS))


def cunet_state(scale, seed):
    module, _ = registry.create_model("cunet/art", scale, 1)
    return convert.state_from_flax(registry.init_params(module, seed=seed),
                                   convert.cunet_mapping(scale))


def make_artifacts(d: Path) -> dict:
    """{name: .onnx path} of every artifact form: onnx_build swin (fused
    and decomposed LayerNorm) and cunet 1x / 2x; torch exports of swin
    (dynamic batch) and cunet 2x; the swin export constant-folded,
    fp16-quantized and externalized."""
    out = {}
    state = swin_state(1)
    out["build_swin"] = pbuild.build_swin_onnx(
        state, 2, (64, 64), d / "build_swin.onnx", base_dim=32,
        depths=DEPTHS)
    out["build_swin_decomposed_ln"] = pbuild.build_swin_onnx(
        state, 2, (64, 64), d / "build_swin_dln.onnx", base_dim=32,
        depths=DEPTHS, decomposed_ln=True)
    for scale in (1, 2):
        out[f"build_cunet{scale}"] = pbuild.build_cunet_onnx(
            cunet_state(scale, scale), scale, d / f"build_cunet{scale}.onnx")
    out["torch_swin"] = export_torch_swin(
        d / "torch_swin.onnx", scale=2, base_dim=32, depths=DEPTHS, tile=64,
        seed=2)[1]
    out["torch_cunet"] = export_torch_cunet(d / "torch_cunet.onnx", scale=2,
                                            tile=76, seed=2)[1]
    out["torch_swin_folded"] = pbuild.fold_model(
        out["torch_swin"], d / "torch_swin_folded.onnx")
    out["torch_swin_fp16"] = pbuild.quantize_initializers_fp16(
        out["torch_swin"], d / "torch_swin_fp16.onnx")
    ext = d / "ext"
    ext.mkdir()
    out["torch_swin_external"] = pbuild.externalize_initializers(
        out["torch_swin"], ext / "torch_swin_ext.onnx", threshold_bytes=1024)
    return out


def probe(path, n=1):
    """A seeded (n, 3, h, w) input at the artifact's probe geometry."""
    h = 76 if "cunet" in Path(path).name else 64
    return np.random.default_rng(7).uniform(
        0, 1, (n, 3, h, h)).astype(np.float32)


def rewrite(src, dst, edit):
    """``src`` re-serialized after ``edit(node)`` of every parsed node (an
    artifact that parses alike but computes other math)."""
    graph = pgraph.read_graph(src)
    for node in graph.nodes:
        edit(node)
    nodes = [pbuild.node_proto(n.op_type, n.inputs, n.outputs, name=n.name,
                               **n.attrs) for n in graph.nodes]
    return pbuild.write_model(nodes, graph.initializers, graph.inputs,
                              graph.outputs, dst, graph_name=graph.name)
