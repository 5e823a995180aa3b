"""Serve real ONNX release artifacts: architecture probe, positional
weight conversion, conversion verification and the graph module.

The port's copy of ``waifu2x_tensorrt_tpu.models.onnx_backend``, layered on
the parser and executors of ``onnx_graph.py`` (the reference's core
capability is "hand it any release ONNX and it runs": nvonnxparser ->
TensorRT engine, img2img_build.cpp:88):

- ``derive_arch(graph)``: the architecture hyperparameters (scale, offset,
  window, per-stage dims/heads/depths) from a shape-probe run of the graph;
- ``swin_params_from_graph`` / ``cunet_params_from_graph``: NAME-INDEPENDENT
  weight conversion into the flat flax-named dict that
  ``registry.load_into`` takes (initializers classified by the roles of
  their consuming nodes in topological order);
- ``verify_swin_conversion`` / ``verify_cunet_conversion``: re-export the
  converted weights (``onnx_build``) and hold both graphs against each
  other under the numpy executor; ``.verify.json`` records of the verdicts;
- ``GraphModule``: an ``nn.Module`` over ``run_graph_torch`` taking the
  renderer's NHWC tiles, one graph run per tile (``torch.func.vmap``), so
  an artifact serves through its own graph (``--graph-exact``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from waifu2x_tensorrt_tpu_torch.models.convert import (
    _KIND_TRANSFORM,
    conv_weight,
    cunet_mapping,
    state_from_flax,
    swin_mapping,
)
from waifu2x_tensorrt_tpu_torch.models.onnx_build import (
    build_cunet_onnx,
    build_swin_onnx,
)
from waifu2x_tensorrt_tpu_torch.models.onnx_graph import (
    OnnxGraph,
    _eval_node,
    graph_params,
    read_graph,
    run_graph,
    run_graph_torch,
)
from waifu2x_tensorrt_tpu_torch.models.swin_unet import (
    _relative_position_index,
)

__all__ = [
    "ArchInfo",
    "derive_arch",
    "swin_params_from_graph",
    "cunet_params_from_graph",
    "GraphModule",
    "verify_cunet_conversion",
    "verify_swin_conversion",
]


@dataclasses.dataclass
class ArchInfo:
    """Architecture facts recovered from a parsed graph."""

    arch: str            # "swin_unet" | "cunet" (attention presence)
    scale: int
    offset: int          # per-side output-space context shrink
    window: int = 0
    base_dim: int = 0
    stage_dims: tuple = ()
    stage_heads: tuple = ()
    stage_depths: tuple = ()
    probe_hw: tuple = ()
    static_hw: tuple = ()  # non-empty: export only runs at this geometry

    def summary(self) -> dict:
        return dataclasses.asdict(self)


def _record_shapes(graph: OnnxGraph, hw: tuple[int, int]):
    """Execute the graph on a zero probe input, returning (records, env):
    records = [(node, [output shapes])] in node order."""
    env: dict = dict(graph.initializers)
    env[graph.inputs[0]] = np.zeros((1, 3, hw[0], hw[1]), np.float32)
    records = []
    for node in graph.nodes:
        _eval_node(node, env)
        records.append(
            (node, [env[o].shape for o in node.outputs if o in env]))
    return records, env


def _probe_candidates(graph: OnnxGraph) -> list[tuple[int, int]]:
    """Input geometries (h, w) to try for the shape probe, best guess
    first. Three sources, in trust order:

    1. The export's declared input ValueInfo shape (graph.input_shapes):
       static torch traces record the exact (1, 3, H, W) geometry there —
       including tiles outside every heuristic list (160/192/256/400/640
       release shapes).
    2. 6-long window-partition reshape targets ((B, h/ws, ws, w/ws, ws, c)
       with B either 1 or the tracer's dynamic -1) as baked by onnx_build's
       static exports — recover h from the stage-1 partition at half
       resolution.
    3. A fallback list of common square tiles (dynamic-shape exports run
       at any legal size, so the first entry succeeds).
    """
    sizes: list[tuple[int, int]] = []
    declared = graph.input_shapes.get(graph.inputs[0]) if graph.inputs \
        else None
    if declared and len(declared) == 4:
        h, w = declared[2], declared[3]
        if isinstance(h, int) and isinstance(w, int) and h > 0 and w > 0:
            sizes.append((h, w))
    for node in graph.nodes:
        if node.op_type != "Reshape" or len(node.inputs) < 2:
            continue
        tgt = graph.initializers.get(node.inputs[1])
        if tgt is None or tgt.size != 6:
            continue
        t = tgt.astype(np.int64)
        if t[2] == t[4] and t[0] in (1, -1):  # (B, ny, ws, nx, ws, c)
            # ONNX Reshape allows one -1, so at most one of ny/nx is
            # dynamic; recover each side independently and fall back to
            # square from the static one (rectangular static exports keep
            # both). A reshape where neither side is recoverable keeps
            # scanning for a later partition reshape.
            ph = int(t[1] * t[2])
            pw = int(t[3] * t[4])
            if ph <= 0:
                ph = pw
            if pw <= 0:
                pw = ph
            if ph > 0:
                for f in (2, 1, 4):
                    if (f * ph, f * pw) not in sizes:
                        sizes.append((f * ph, f * pw))
                break
    for s in (64, 96, 32, 128):
        if (s, s) not in sizes:
            sizes.append((s, s))
    return sizes


def derive_arch(graph: OnnxGraph,
                probe_hw: Optional[tuple[int, int]] = None) -> ArchInfo:
    """Derive the architecture from the graph by shape-probing it.

    Softmax nodes reveal the attention geometry ((nW, heads, N, N) with
    N = window**2); consecutive runs of equal block dim give the stage
    depths; scale/offset come from the probe's input/output sizes — solved
    exactly from two probe sizes when the graph accepts more than one
    geometry, else from the upsample-op presence.
    """
    last_err: Optional[Exception] = None
    candidates = ([probe_hw] if probe_hw is not None
                  else _probe_candidates(graph))
    records = env = hw = None
    for cand in candidates:
        try:
            records, env = _record_shapes(graph, cand)
            hw = cand
            break
        except Exception as e:  # wrong geometry for a static graph
            last_err = e
    if records is None:
        raise ValueError(
            f"could not shape-probe the graph at any of {candidates}: "
            f"{last_err}")

    out_shape = env[graph.outputs[0]].shape
    oh = out_shape[2]

    # scale/offset: oh = scale*h - 2*offset. A second probe size separates
    # the (scale, offset) pairs that alias at one size (cunet's context
    # shrink); static graphs only run at one geometry, where upsample ops
    # (DepthToSpace / strided ConvTranspose) pin the scale.
    h2 = (hw[0] + 32, hw[1] + 32)
    static_hw: tuple = ()
    try:
        _, env2 = _record_shapes(graph, h2)
        oh2 = env2[graph.outputs[0]].shape[2]
        scale = (oh2 - oh) // (h2[0] - hw[0])
    except Exception:
        static_hw = tuple(hw)  # geometry is baked into the export
        up = 1
        for node, shapes in records:
            if node.op_type == "DepthToSpace":
                up *= int(node.attrs["blocksize"])
            elif node.op_type == "ConvTranspose":
                up *= int(node.attrs.get("strides", [1, 1])[0])
            elif node.op_type == "Conv":
                up /= int(node.attrs.get("strides", [1, 1])[0])
        # net spatial factor of the whole graph == scale (crops change
        # size additively, not multiplicatively)
        scale = max(1, int(round(up)))
    offset = (hw[0] * scale - oh) // 2

    # attention geometry from Softmax records
    out_to_shape: dict[str, tuple] = {}
    for node, shapes in records:
        for o, s in zip(node.outputs, shapes):
            out_to_shape[o] = s
    dims: list[int] = []
    heads: list[int] = []
    window = 0
    for i, (node, shapes) in enumerate(records):
        # (nW, nh, N, N) from the repo's exports; torch's tracer keeps the
        # batch dim separate: (B, nW, nh, N, N). Index from the end.
        if node.op_type != "Softmax" or not shapes or len(shapes[0]) not in (4, 5):
            continue
        nh, n_tok = shapes[0][-3], shapes[0][-1]
        window = int(math.isqrt(n_tok))
        # the consumer MatMul's output minor dim is head_dim
        hd = 0
        sm_out = node.outputs[0]
        for node2, shapes2 in records[i + 1:]:
            if node2.op_type == "MatMul" and sm_out in node2.inputs:
                hd = shapes2[0][-1]
                break
        dims.append(nh * hd)
        heads.append(nh)

    stage_dims: list[int] = []
    stage_heads: list[int] = []
    stage_depths: list[int] = []
    for d, h_ in zip(dims, heads):
        if stage_dims and stage_dims[-1] == d:
            stage_depths[-1] += 1
        else:
            stage_dims.append(d)
            stage_heads.append(h_)
            stage_depths.append(1)

    arch = "swin_unet" if dims else "cunet"
    base_dim = stage_dims[0] if stage_dims else 0
    return ArchInfo(
        arch=arch, scale=scale, offset=offset, window=window,
        base_dim=base_dim, stage_dims=tuple(stage_dims),
        stage_heads=tuple(stage_heads), stage_depths=tuple(stage_depths),
        probe_hw=tuple(hw), static_hw=static_hw,
    )


# ---------------------------------------------------------------------------
# Name-independent (positional) swin weight conversion
# ---------------------------------------------------------------------------


def _weight_through(graph: OnnxGraph, producers: dict, name: str):
    """Follow ``name`` back through Transpose([1,0])/Identity to an
    initializer. Returns (array, transposed) or None; ``transposed`` means
    the stored array is (out, in) relative to the MatMul's (in, out)."""
    trans = False
    for _ in range(4):
        if name in graph.initializers:
            return graph.initializers[name], trans
        node = producers.get(name)
        if node is None:
            return None
        if node.op_type == "Transpose" and list(
                node.attrs.get("perm", [])) == [1, 0]:
            trans = not trans
            name = node.inputs[0]
        elif node.op_type == "Identity":
            name = node.inputs[0]
        else:
            return None
    return None


_BLOCK_LINEARS = ("qkv", "proj", "fc1", "fc2")


def _folded_bias(node, _init) -> Optional[np.ndarray]:
    """Return the constant input of an Add that looks like a constant-
    folded relative-position bias ((..., nh, N, N) float, N a square,
    values in a sane logit-bias range — the cyclic-shift mask constant has
    -1e9 entries and is rejected)."""
    for inp in node.inputs:
        cand = _init(inp)
        if (cand is not None and cand.dtype.kind == "f" and cand.ndim >= 3
                and cand.shape[-1] == cand.shape[-2] and cand.shape[-1] > 1
                and math.isqrt(cand.shape[-1]) ** 2 == cand.shape[-1]
                and float(cand.min()) > -1e4):
            return cand
    return None


def _table_from_folded_bias(bias: np.ndarray) -> np.ndarray:
    """Invert table[rel_position_index] -> table.

    Every relative offset pair in [-(ws-1), ws-1]^2 occurs inside a single
    ws*ws window, so each of the (2ws-1)^2 table rows appears in the folded
    (nh, N, N) bias at least once — read each back from its first
    occurrence."""
    n = bias.shape[-1]
    ws = math.isqrt(n)
    nh = int(np.prod(bias.shape[:-2]))
    flat_idx = np.asarray(_relative_position_index(ws)).reshape(-1)
    first = np.full((2 * ws - 1) ** 2, 0, np.int64)
    first[flat_idx[::-1]] = np.arange(n * n)[::-1]
    return np.ascontiguousarray(
        bias.reshape(nh, n * n)[:, first].T)


def swin_params_from_graph(graph: OnnxGraph) -> dict[str, np.ndarray]:
    """Convert a SwinUNet export to the FLAT flax-named param dict
    (``registry.load_into``'s input) WITHOUT relying on initializer names: roles are assigned by walking the (topologically
    sorted) node list and matching the SwinUNet structure —

        Conv stem x2, down1 Conv, [stage-1 blocks], down2 Conv,
        [stage-2 blocks], up2 Linear, [stage-3 blocks], up1 Linear,
        to_image Conv

    where each block contributes, in node order: norm1 (LN), qkv (Linear),
    rel-pos table (Gather on a 2-D float initializer), proj (Linear),
    norm2 (LN), fc1, fc2. Stage membership falls out of the block dims
    (norm scale length). Raises ValueError with the observed structure when
    the walk doesn't parse — the honest failure mode for an architecture
    that actually differs from the reconstruction.

    Handles BOTH fused LayerNormalization nodes (opset >= 17) and the
    pre-opset-17 decomposed chain (ReduceMean/Sub/Pow/Sqrt/Div/Mul/Add —
    the Mul-by-channel-vector-after-Div tail marks the norm, the
    following Add its bias); ``--rename-json`` + convert.swin_from_torch
    remains the escape hatch for exports neither form parses.
    """
    producers: dict[str, "object"] = {}
    for n in graph.nodes:
        for o in n.outputs:
            producers[o] = n

    # torch's tracer routes parameters through leading Identity nodes and
    # materializes folded constants as Constant nodes; resolve both so LN
    # scales / rel-pos tables are found.
    _init = _resolve_init(graph, producers)

    convs: list[tuple[np.ndarray, Optional[np.ndarray]]] = []
    blocks: list[dict] = []
    standalone: list[dict] = []
    cur: Optional[dict] = None
    pending: Optional[tuple[dict, str, str]] = None  # (slot dict, key, out)
    norm_pending: Optional[tuple[dict, str, str]] = None

    def block_complete(b: Optional[dict]) -> bool:
        return b is not None and "fc2/kernel" in b

    def start_norm(s):
        nonlocal cur
        if cur is None or block_complete(cur) or "norm2/scale" in cur:
            cur = {}
            blocks.append(cur)
            key = "norm1"
        else:
            key = "norm2"
        cur[f"{key}/scale"] = s
        return key

    for node in graph.nodes:
        op = node.op_type
        if op in ("Conv", "ConvTranspose"):
            w = _init(node.inputs[1])
            b = (_init(node.inputs[2])
                 if len(node.inputs) > 2 else None)
            if w is not None:
                convs.append((w, b))
            pending = None
        elif op == "LayerNormalization":
            s = _init(node.inputs[1])
            b = (_init(node.inputs[2])
                 if len(node.inputs) > 2 else None)
            if s is None:
                continue
            key = start_norm(s)
            if b is not None:
                cur[f"{key}/bias"] = b
            pending = None
        elif op == "Mul":
            # decomposed pre-opset-17 LayerNorm tail: Mul(Div(x-mu, std),
            # scale_1d) followed by Add(·, bias_1d). Guards: the 1-D
            # initializer must be a real channel vector (size > 1 — GELU/
            # attention scalar Muls have size 1) and the other input must
            # come from a Div (the normalize step).
            sc = None
            div_in = False
            for inp in node.inputs:
                cand = _init(inp)
                if (cand is not None and cand.ndim == 1 and cand.size > 1
                        and cand.dtype.kind == "f"):
                    sc = cand
                else:
                    prod = producers.get(inp)
                    if prod is not None and prod.op_type == "Div":
                        div_in = True
            if sc is not None and div_in:
                key = start_norm(sc)
                norm_pending = (cur, key, node.outputs[0])
        elif op in ("MatMul", "Gemm"):
            got = _weight_through(graph, producers, node.inputs[1])
            if got is None:
                pending = None
                continue
            w, transposed = got
            if op == "Gemm":
                # transB composes with any Transpose the walk crossed
                # (e.g. Gemm fed by Transpose(initializer)): XOR, don't
                # overwrite
                transposed ^= bool(node.attrs.get("transB", 0))
            kernel = np.ascontiguousarray(w.T) if transposed else w
            # kernel is now (in, out) == the flax Dense layout
            if cur is not None and not block_complete(cur):
                slot = next(s for s in _BLOCK_LINEARS
                            if f"{s}/kernel" not in cur)
                cur[f"{slot}/kernel"] = kernel
                target, key = cur, slot
            else:
                standalone.append({"kernel": kernel})
                target, key = standalone[-1], ""
            if op == "Gemm" and len(node.inputs) > 2:
                b = _init(node.inputs[2])
                if b is not None:
                    target[f"{key}/bias" if key else "bias"] = b
                pending = None
            else:
                pending = (target, key, node.outputs[0])
        elif op == "Add" and cur is not None and "table" not in cur \
                and not block_complete(cur) \
                and (fb := _folded_bias(node, _init)) is not None:
            # torch's constant folder precomputes table[rel_index] into an
            # (..., nh, N, N) Add constant — invert it back to the
            # ((2ws-1)^2, nh) table the flax module parameterizes. (The
            # shift-mask Add constant is excluded by its -1e9 entries.)
            cur["table"] = _table_from_folded_bias(fb)
        elif op == "Add" and (pending is not None
                              or norm_pending is not None):
            if norm_pending is not None and norm_pending[2] in node.inputs:
                target, key, nm_out = norm_pending
                other = [i for i in node.inputs if i != nm_out]
                b = _init(other[0]) if other else None
                if b is not None and b.ndim == 1:
                    target[f"{key}/bias"] = b
                norm_pending = None
                continue
            if pending is not None:
                target, key, mm_out = pending
                if mm_out in node.inputs:
                    other = [i for i in node.inputs if i != mm_out]
                    b = _init(other[0]) if other else None
                    if b is not None and b.ndim == 1:
                        target[f"{key}/bias" if key else "bias"] = b
                pending = None
        elif op == "Gather":
            data = _init(node.inputs[0])
            if (data is not None and data.ndim == 2
                    and data.dtype == np.float32 and cur is not None
                    and "table" not in cur):
                cur["table"] = data

    if len(convs) != 5:
        raise ValueError(
            f"expected 5 convs (stem x2, down x2, to_image), found "
            f"{len(convs)} — architecture differs from the reconstruction")
    if len(standalone) != 2:
        raise ValueError(
            f"expected 2 decoder linears (up2, up1), found "
            f"{len(standalone)}")
    # every block must carry both LN scales, all four linears, and the
    # rel-pos table before assembly — a missing slot (an LN idiom
    # _resolve_init does not chase, a table the folded-bias inversion
    # missed) must surface as the loader-cacheable diagnostic ValueError,
    # not a raw KeyError that bypasses the .verify.json failure cache
    # (subsumes the old block_complete/table incompleteness check)
    required = ["norm1/scale", "norm2/scale", "table"] + [
        f"{lin}/kernel" for lin in _BLOCK_LINEARS]
    for bi, b in enumerate(blocks):
        missing = [k for k in required if k not in b]
        if missing:
            raise ValueError(
                f"attention block {bi}: could not resolve {missing} from "
                f"the graph (unrecognized LayerNorm/bias idiom?)")

    # stage grouping by block dim (norm1 scale length): c, 2c, c
    stage_of: list[tuple[str, int]] = []
    runs: list[tuple[int, int]] = []  # (dim, count)
    for b in blocks:
        d = b["norm1/scale"].shape[0]
        if runs and runs[-1][0] == d:
            runs[-1] = (d, runs[-1][1] + 1)
        else:
            runs.append((d, 1))
    if len(runs) != 3:
        raise ValueError(
            f"expected 3 attention stages (dims c, 2c, c), found "
            f"{[r[0] for r in runs]}")
    for stage, (_, count) in zip(("swin1", "swin2", "swin3"), runs):
        for i in range(count):
            stage_of.append((stage, i))

    # Bias-free layers (e.g. bias=False in the exporting module) synthesize
    # an exact zero bias: the flax modules are built with use_bias=True, so
    # an omitted key would pass conversion AND verification (the re-export
    # writer mirrors whatever keys exist) and then crash the first render
    # with ScopeParamNotFoundError. Zero bias is mathematically identical.
    flat: dict[str, np.ndarray] = {}
    conv_names = ("patch_conv1", "patch_conv2", "down1", "down2", "to_image")
    for name, (w, b) in zip(conv_names, convs):
        k = conv_weight(w.astype(np.float32))
        flat[f"{name}/kernel"] = k
        flat[f"{name}/bias"] = (b.astype(np.float32) if b is not None
                                else np.zeros(k.shape[-1], np.float32))
    for name, lin in zip(("up2", "up1"), standalone):
        k = lin["kernel"].astype(np.float32)
        flat[f"{name}/kernel"] = k
        flat[f"{name}/bias"] = (lin["bias"].astype(np.float32)
                                if "bias" in lin
                                else np.zeros(k.shape[-1], np.float32))
    for b, (stage, i) in zip(blocks, stage_of):
        fb = f"{stage}/block{i}"
        for key in ("norm1", "norm2"):
            flat[f"{fb}/{key}/scale"] = b[f"{key}/scale"].astype(np.float32)
            flat[f"{fb}/{key}/bias"] = (
                b[f"{key}/bias"].astype(np.float32)
                if f"{key}/bias" in b
                else np.zeros_like(b[f"{key}/scale"], dtype=np.float32))
        for lin in _BLOCK_LINEARS:
            dst = {"qkv": "attn/qkv", "proj": "attn/proj",
                   "fc1": "mlp_fc1", "fc2": "mlp_fc2"}[lin]
            k = b[f"{lin}/kernel"].astype(np.float32)
            flat[f"{fb}/{dst}/kernel"] = k
            flat[f"{fb}/{dst}/bias"] = (
                b[f"{lin}/bias"].astype(np.float32)
                if f"{lin}/bias" in b
                else np.zeros(k.shape[-1], np.float32))
        flat[f"{fb}/attn/relative_position_bias"] = b["table"].astype(
            np.float32)
    return flat


# ---------------------------------------------------------------------------
# Load-time artifact verification (parse -> optimize, TensorRT-style)
# ---------------------------------------------------------------------------


# fp32 agreement gate between an artifact's graph and the converted
# reconstruction's re-export (both under the numpy executor); also the
# ceiling a .verify.json sidecar's cached max_err is trusted up to.
VERIFY_TOL = 1e-4


def _converter_fingerprint() -> str:
    """sha256[:12] over the source of every module a cached verification
    verdict depends on — the positional converters and shape probe (this
    module), the parser/executors, the re-export writer, the weight
    transforms, and the torch modules that serve a verified artifact. Any
    edit to any of them (even a comment) invalidates sidecars:
    re-verification costs seconds at the next load (PERF.md), serving a
    stale verdict costs wrong pixels. The files are the port's
    own, so a sidecar the JAX package wrote never matches (and the JAX
    package re-verifies one the port wrote)."""
    h = hashlib.sha256()
    base = Path(__file__).resolve().parent
    for f in ("onnx_backend.py", "onnx_graph.py", "onnx_build.py",
              "convert.py", "swin_unet.py", "cunet.py", "layers.py"):
        h.update((base / f).read_bytes())
    return h.hexdigest()[:12]


# Keyed into .verify.json sidecars; cached verdicts from a DIFFERENT
# version are ignored (a converter upgrade must not be masked by a stale
# cached parse failure, nor a cached success trusted across a conversion
# change). Source-derived so nobody has to remember to bump it — the
# engine cache's code-version analogue applied to fidelity.
CONVERTER_VERSION = "torch-2-" + _converter_fingerprint()


def _sha16(path: Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()[:16]


def write_npz_verification(npz_path, payload: dict) -> Path:
    """Record a passed conversion check next to a saved ``.npz``
    (validate.py writes this after its executed-graph-vs-flax gate), keyed
    by the npz's own content hash so a re-saved or edited file is never
    trusted on old evidence. ``Upscaler.load`` uses it to drop the
    "fidelity unverified" warning for checkpoints validate.py proved.
    """
    npz_path = Path(npz_path)
    sidecar = npz_path.with_name(npz_path.name + ".verify.json")
    sidecar.write_text(json.dumps({
        "npz_sha16": _sha16(npz_path),
        "converter_version": CONVERTER_VERSION,
        **payload,
    }, default=str))
    return sidecar


def npz_verification(npz_path) -> Optional[dict]:
    """The recorded conversion verdict for a ``.npz``, or None when absent,
    unreadable, converter-version-stale, content-stale, or above the trust
    gate (VERIFY_TOL). A converter-version-stale record is rejected
    although the .npz bytes are immutable: the verdict transited the port's
    modules (validate.py's forward), so an edit to them invalidates the
    evidence exactly as it does for .onnx sidecars."""
    npz_path = Path(npz_path)
    sidecar = npz_path.with_name(npz_path.name + ".verify.json")
    if not sidecar.exists():
        return None
    try:
        rec = json.loads(sidecar.read_text())
        err = float(rec["max_err"])
    except (OSError, ValueError, KeyError, TypeError):
        return None
    if rec.get("converter_version") != CONVERTER_VERSION:
        return None
    if rec.get("npz_sha16") != _sha16(npz_path):
        return None
    if not (err <= VERIFY_TOL):  # also rejects NaN
        return None
    return rec


def verify_swin_conversion(graph: OnnxGraph, arch: ArchInfo,
                           params: dict, tol: float = VERIFY_TOL) -> float:
    """Prove the positional conversion faithful for THIS artifact, fully
    host-side: re-export the converted flax params through onnx_build's
    writer (whose conventions are test-pinned equal to the flax forward,
    tests/test_onnx_executor.py round trips) and execute BOTH graphs with
    the numpy ground-truth executor on one probe tile. Agreement proves,
    transitively, that the flax reconstruction reproduces the artifact's
    own math — per-artifact evidence replacing the architecture-match
    hope. Returns the max abs error;
    raises ValueError above ``tol`` (e.g. an export using tanh-GELU or a
    different norm epsilon than upstream nunif: structurally convertible,
    numerically different — those must serve graph-exact instead).
    """
    d = arch.stage_depths
    depths5 = (d[0], d[0], d[1], d[2], d[2])
    state = state_from_flax(params, swin_mapping(arch.scale, depths5))
    hw = tuple(arch.probe_hw) or (32, 32)
    with tempfile.TemporaryDirectory() as td:
        ref = build_swin_onnx(state, arch.scale, hw,
                              Path(td) / "reexport.onnx",
                              base_dim=arch.base_dim, depths=depths5)
        regraph = read_graph(ref)
        rng = np.random.default_rng(0)
        x = rng.uniform(0.0, 1.0, (1, 3, *hw)).astype(np.float32)
        a = run_graph(graph, {graph.inputs[0]: x})[graph.outputs[0]]
        b = run_graph(regraph, {regraph.inputs[0]: x})[regraph.outputs[0]]
    if a.shape != b.shape:
        raise ValueError(
            f"artifact output shape {a.shape} != reconstruction "
            f"re-export {b.shape}")
    err = float(np.abs(a - b).max())
    if err > tol:
        raise ValueError(
            f"artifact diverges from the flax reconstruction: max abs "
            f"err {err:.3e} > {tol:g} on a {hw} probe (the conversion "
            f"parsed, but the graph computes different math)")
    return err


def _resolve_init(graph: OnnxGraph, producers: Optional[dict] = None):
    """Return a name -> ndarray resolver that chases the torch tracer's
    leading Identity nodes and materialized Constant nodes — the shared
    initializer resolution both positional converters use. Pass an
    already-built output-name -> node map to skip rebuilding it."""
    if producers is None:
        producers = {}
        for n in graph.nodes:
            for o in n.outputs:
                producers[o] = n

    def _init(name: str) -> Optional[np.ndarray]:
        for _ in range(5):
            if name in graph.initializers:
                return graph.initializers[name]
            node = producers.get(name)
            if node is None:
                return None
            if node.op_type == "Constant":
                return node.attrs.get("value")
            if node.op_type != "Identity":
                return None
            name = node.inputs[0]
        return None

    return _init


def cunet_params_from_graph(graph: OnnxGraph,
                            scale: Optional[int] = None
                            ) -> dict[str, np.ndarray]:
    """Convert a CUNet/UpCUNet export to the FLAT flax-named param dict
    WITHOUT
    relying on initializer names.

    The family's weighted ops form ONE fixed execution-order sequence —
    exactly ``convert.cunet_mapping`` order (unet1 then unet2, each
    sequential) — so the topologically-sorted node walk assigns roles
    positionally, the same strategy as ``swin_params_from_graph``. SE
    squeeze layers are accepted in every exporter form seen in the wild:
    Conv 1x1 (upstream nunif's ``nn.Conv2d(..., 1)``), Gemm (transB
    honored), or MatMul with a following bias Add.

    ``scale`` is inferred from the deconv count when omitted (UpCUNet's
    unet1 head is a ConvTranspose: 4 deconvs vs CUNet's 3). Raises
    ValueError with the observed sequence when the walk doesn't parse.
    (Ref workflow: main.cpp:201-204 hands such exports to nvonnxparser.)
    """
    _init = _resolve_init(graph)

    # (op_kind, torch-layout weight, bias) in execution order; op_kind is
    # "conv" | "deconv" | "dense" after layout normalization
    seen: list[list] = []
    pending_mm: Optional[str] = None  # MatMul output awaiting a bias Add
    for node in graph.nodes:
        op = node.op_type
        if op in ("Conv", "ConvTranspose"):
            w = _init(node.inputs[1])
            if w is None:
                continue
            b = _init(node.inputs[2]) if len(node.inputs) > 2 else None
            kind = "deconv" if op == "ConvTranspose" else "conv"
            if kind == "conv" and w.ndim == 4 and w.shape[2:] == (1, 1):
                kind, w = "dense", w[:, :, 0, 0]  # SE squeeze as 1x1 conv
            seen.append([kind, w, b])
            pending_mm = None
        elif op == "Gemm":
            w = _init(node.inputs[1])
            if w is None or node.attrs.get("transA", 0):
                continue  # transposed activations never trace from Linear
            if not node.attrs.get("transB", 0):
                w = w.T  # normalize to torch (O, I)
            w = w * np.float32(node.attrs.get("alpha", 1.0))
            b = _init(node.inputs[2]) if len(node.inputs) > 2 else None
            if b is not None:
                b = b * np.float32(node.attrs.get("beta", 1.0))
            seen.append(["dense", w, b])
            pending_mm = None
        elif op == "MatMul":
            w = _init(node.inputs[1])
            if w is None or w.ndim != 2:
                continue
            seen.append(["dense", w.T, None])  # (I, O) -> (O, I)
            pending_mm = node.outputs[0]
        elif op == "Add" and pending_mm is not None \
                and pending_mm in node.inputs:
            other = [i for i in node.inputs if i != pending_mm]
            b = _init(other[0]) if other else None
            # accept (O,) and broadcast-shaped (1, ..., 1, O) biases
            if b is not None and b.ndim >= 1 and b.size == b.shape[-1]:
                seen[-1][2] = b.reshape(-1)
            pending_mm = None

    if scale is None:
        n_deconv = sum(1 for k, _, _ in seen if k == "deconv")
        scale = 2 if n_deconv >= 4 else 1
    expected = cunet_mapping(scale)
    got_kinds = [k for k, _, _ in seen]
    want_kinds = [k for _, _, k in expected]
    if got_kinds != want_kinds:
        raise ValueError(
            f"graph's weighted-op sequence does not match CUNet "
            f"(scale {scale}): got {len(got_kinds)} ops "
            f"{got_kinds[:8]}..., expected {len(want_kinds)} "
            f"{want_kinds[:8]}...")

    flat: dict[str, np.ndarray] = {}
    for (kind, w, b), (_src, dst, _k) in zip(seen, expected):
        k = _KIND_TRANSFORM[kind](w).astype(np.float32)
        flat[f"{dst}/kernel"] = k
        # bias-free layers get an exact zero bias — the flax modules are
        # use_bias=True throughout, so an omitted key would verify clean
        # and then crash the first render (see swin_params_from_graph)
        flat[f"{dst}/bias"] = (np.asarray(b, np.float32).reshape(-1)
                               if b is not None
                               else np.zeros(k.shape[-1], np.float32))
    return flat


def verify_cunet_conversion(graph: OnnxGraph, arch: ArchInfo,
                            params: dict, tol: float = VERIFY_TOL) -> float:
    """CUNet analogue of ``verify_swin_conversion``: re-export the
    converted flax params through onnx_build's writer and execute BOTH
    graphs under the numpy ground-truth executor on one probe tile.
    Returns the max abs error; raises ValueError above ``tol``."""
    state = state_from_flax(params, cunet_mapping(arch.scale))
    hw = tuple(arch.probe_hw) if arch.probe_hw else (0, 0)
    if min(hw) <= 56 or any(d % 4 for d in hw):
        hw = (76, 76)  # > 56-px context loss, /4 for the two downsamples
    with tempfile.TemporaryDirectory() as td:
        ref = build_cunet_onnx(state, arch.scale, Path(td) / "reexport.onnx")
        regraph = read_graph(ref)
        rng = np.random.default_rng(0)
        x = rng.uniform(0.0, 1.0, (1, 3, *hw)).astype(np.float32)
        a = run_graph(graph, {graph.inputs[0]: x})[graph.outputs[0]]
        b = run_graph(regraph, {regraph.inputs[0]: x})[regraph.outputs[0]]
    if a.shape != b.shape:
        raise ValueError(
            f"artifact output shape {a.shape} != reconstruction "
            f"re-export {b.shape}")
    err = float(np.abs(a - b).max())
    if err > tol:
        raise ValueError(
            f"artifact diverges from the cunet reconstruction: max abs "
            f"err {err:.3e} > {tol:g} on a {hw} probe (the conversion "
            f"parsed, but the graph computes different math)")
    return err


# ---------------------------------------------------------------------------
# Graph-exact serving module
# ---------------------------------------------------------------------------


class GraphModule(nn.Module):
    """``nn.Module`` over a parsed ONNX graph.

    ``forward(tiles)`` takes an NHWC tile batch (what the renderer feeds
    every model) and runs the graph once per tile (NCHW, batch 1 — the
    export layout; many exports pin batch 1 in a Reshape) under
    ``torch.func.vmap``, so the batch still runs as batched tensor ops.
    The float initializers are buffers, cast once to the compute dtype;
    the graph's other constants are copied to the device at first use
    and kept.

    ``compute_dtype=None`` runs the export's own fp32 math (the
    ground-truth mode ``validate`` cross-checks against);
    ``compute_dtype=torch.bfloat16`` runs the graph in bf16 with fp32
    islands (``onnx_graph._PRECISE_OPS``) — the reference's
    fp16-engine-from-fp32-artifact behaviour (img2img_build.cpp:88).
    """

    def __init__(self, graph: OnnxGraph,
                 compute_dtype: Optional[torch.dtype] = None,
                 device=None) -> None:
        super().__init__()
        self.graph = graph
        self.compute_dtype = compute_dtype
        self._in = graph.inputs[0]
        self._out = graph.outputs[0]
        self._buffer_of: dict[str, str] = {}
        for i, (name, value) in enumerate(graph_params(graph).items()):
            t = torch.from_numpy(np.array(value, np.float32))
            self.register_buffer(
                f"w{i}", t.to(device=device, dtype=compute_dtype or
                              torch.float32))
            self._buffer_of[name] = f"w{i}"
        self._consts: dict = {}

    def params(self) -> dict[str, torch.Tensor]:
        """{initializer name: buffer}: ``run_graph_torch``'s ``params``."""
        return {k: getattr(self, b) for k, b in self._buffer_of.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        params = self.params()

        def one(img):  # (H, W, 3) -> (oh, ow, 3)
            feeds = {self._in: img.permute(2, 0, 1).unsqueeze(0)}
            y = run_graph_torch(self.graph, feeds, params=params,
                                compute_dtype=cd,
                                consts=self._consts)[self._out]
            return y[0].permute(1, 2, 0)

        y = torch.func.vmap(one)(x.to(cd or torch.float32))
        return y.to(x.dtype).contiguous()

