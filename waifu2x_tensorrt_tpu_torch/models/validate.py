"""Validate + convert a real ONNX artifact against the port's modules.

Usage:
    python -m waifu2x_tensorrt_tpu_torch.models.validate MODEL.onnx \
        --family swin_unet/art --scale 4 --noise 3 \
        [--tile 64] [--device 0|cpu] [--rename-json table.json] \
        [--save-npz models/swin_unet/art/noise3_scale4x.npz]

The port of ``waifu2x_tensorrt_tpu.models.validate``. Steps:
  1. parse the graph (models/onnx_graph.py), print its topology summary
     (op histogram) and the derived architecture (models/onnx_backend.py
     ``derive_arch``) diffed against the reconstruction's expected
     hyperparameters;
  2. convert the initializers to the flat flax-named weight dict with the
     NAME-INDEPENDENT positional converters (``swin_params_from_graph`` /
     ``cunet_params_from_graph``); ``--rename-json`` (a {src: canonical}
     exact-name table) plus ``convert.swin_from_torch`` /
     ``cunet_from_torch`` is the escape hatch for exports the positional
     walk cannot parse;
  3. execute the graph with the numpy executor (ground truth) AND the
     torch executor (the graph-exact serving path, ``run_graph_torch``)
     and hold both against the port's module forward on a random tile
     (max abs error <= --tolerance in fp32; TF32 off);
  4. optionally save the converted weights where the registry loads them
     (main.cpp:201-204 path convention, .npz instead of .onnx), with a
     ``.verify.json`` record of the passed gate beside them.

The module and the torch executor run on CUDA device 0 unless ``--device``
names another one or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from waifu2x_tensorrt_tpu_torch.models import registry
from waifu2x_tensorrt_tpu_torch.models.convert import (
    cunet_from_torch,
    swin_from_torch,
)
from waifu2x_tensorrt_tpu_torch.models.onnx_backend import (
    _sha16,
    cunet_params_from_graph,
    derive_arch,
    swin_params_from_graph,
    write_npz_verification,
)
from waifu2x_tensorrt_tpu_torch.models.onnx_graph import (
    graph_params,
    read_graph,
    run_graph,
    run_graph_torch,
    summarize,
)
from waifu2x_tensorrt_tpu_torch.models.onnx_reader import (
    OnnxExternalDataError,
)


def _expected_arch(family: str, scale: int):
    """The reconstruction's hyperparameters (models/swin_unet.py,
    models/registry.py get_spec)."""
    if family.startswith("cunet"):
        return {"arch": "cunet", "scale": scale,
                "offset": {1: 28, 2: 36}[scale]}
    return {"arch": "swin_unet", "scale": scale, "offset": 0, "window": 8,
            "base_dim": 96, "stage_dims": (96, 192, 96),
            "stage_heads": (3, 6, 3), "stage_depths": (2, 6, 2)}


def _device_arg(value: str) -> torch.device:
    if value == "cpu":
        return torch.device("cpu")
    try:
        return torch.device("cuda", int(value))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid device {value!r} (an index or 'cpu')") from None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Validate/convert an ONNX waifu2x artifact")
    p.add_argument("onnx_path")
    p.add_argument("--family", required=True)
    p.add_argument("--scale", type=int, required=True)
    p.add_argument("--noise", type=int, default=-1)
    p.add_argument("--tile", type=int, default=64)
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--device", type=_device_arg, default="0",
                   help="CUDA device index, or 'cpu'")
    p.add_argument("--rename-json", default=None,
                   help="JSON {upstream_name: canonical_mirror_name} table; "
                        "forces name-based conversion through it")
    p.add_argument("--save-npz", default=None,
                   help="write the converted weights here on success")
    args = p.parse_args(argv)
    try:
        # the registry's family/scale/noise rules (cunet has no 4x, ...)
        registry.validate(args.family, args.scale,
                          max(args.noise, 0) if args.scale == 1
                          else args.noise)
    except ValueError as e:
        print(f"error: {e}")
        return 2
    device = args.device
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: {device}: no CUDA device is available (pass "
              "--device cpu)")
        return 2
    # the gate is fp32: no TF32 in cuDNN convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    try:
        graph = read_graph(args.onnx_path)
    except OnnxExternalDataError as e:
        # the .onnx itself parsed — its DATA sidecar is what's missing
        print(f"error: {e}")
        print("triage: this artifact stores its weights in an external "
              "data file; copy that file into the same directory as the "
              ".onnx and re-run")
        return 2
    except ValueError as e:
        print(f"error: {e}")
        print("triage: the file is not a parseable ONNX ModelProto — "
              "re-download the artifact or check the path")
        return 2
    print(json.dumps(summarize(graph), indent=2))
    if graph.had_fp16:
        print("note: artifact stores fp16 weights/casts — upcast exactly "
              "to fp32 for conversion and ground-truth execution; serving "
              "precision remains governed by --precision")

    # -- step 1b: derived architecture vs the reconstruction ---------------
    derived = derive_arch(graph)
    expected = _expected_arch(args.family, args.scale)
    print("derived architecture:")
    print(json.dumps(derived.summary(), indent=2, default=str))
    diffs = []
    for key, want in expected.items():
        got = getattr(derived, key, None)
        got = tuple(got) if isinstance(got, (list, tuple)) else got
        want = tuple(want) if isinstance(want, (list, tuple)) else want
        if got != want:
            diffs.append(f"  {key}: derived={got!r} reconstruction={want!r}")
    if diffs:
        print("ARCH DIFF vs reconstruction:")
        print("\n".join(diffs))
    else:
        print("arch matches the reconstruction exactly")

    # -- step 2: conversion -------------------------------------------------
    # the module is built from the DERIVED hyperparameters, so an artifact
    # that structurally matches the swin_unet family validates even when
    # its width/depths differ from the flagship configuration
    renamed = None
    if args.rename_json:
        with open(args.rename_json) as fh:
            table = json.load(fh)
        renamed = {table.get(k, k): v for k, v in graph.initializers.items()}
    kw = {}
    if args.family.startswith("cunet"):
        params = (cunet_from_torch(renamed, args.scale) if renamed
                  is not None else cunet_params_from_graph(
                      graph, scale=args.scale))
    else:
        d = derived.stage_depths or (2, 6, 2)
        kw = {"base_dim": derived.base_dim or 96,
              "depths": (d[0], d[0], d[1], d[2], d[2])}
        params = (swin_from_torch(renamed, args.scale, depths=kw["depths"])
                  if renamed is not None
                  else swin_params_from_graph(graph))
    module, _ = registry.create_model(
        args.family, args.scale, args.noise, dtype=torch.float32,
        fused_block=device.type == "cuda", device=device, **kw)
    registry.load_into(module, params)

    # -- step 3: executed graph (numpy + torch) vs the module forward ------
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (1, 3, args.tile, args.tile)).astype(np.float32)
    got = run_graph(graph, {graph.inputs[0]: x})[graph.outputs[0]]
    xt = torch.from_numpy(x).to(device)
    with torch.inference_mode():
        module_out = module(xt.permute(0, 2, 3, 1)).permute(
            0, 3, 1, 2).cpu().numpy()
    if got.shape != module_out.shape:
        print(f"FAIL: shape mismatch onnx={got.shape} "
              f"module={module_out.shape}")
        return 1
    err = float(np.abs(got - module_out).max())
    print(f"max |onnx(numpy) - port module| = {err:.3e} "
          f"(tolerance {args.tolerance:g})")
    gp = {k: torch.from_numpy(np.array(v, np.float32)).to(device)
          for k, v in graph_params(graph).items()}
    with torch.inference_mode():
        torch_out = run_graph_torch(graph, {graph.inputs[0]: xt},
                                    params=gp)[graph.outputs[0]]
    terr = float(np.abs(torch_out.cpu().numpy() - got).max())
    print(f"max |onnx(torch serving path) - onnx(numpy)| = {terr:.3e}")
    if err > args.tolerance or terr > args.tolerance:
        print("FAIL: forward paths diverge from the executed graph")
        return 1
    print("OK: per-tile forward matches the executed ONNX graph on both "
          "the port module and the torch-serving paths")
    # informational: the drift of bf16 graph serving (--precision fp16
    # with a bare .onnx and --graph-exact) for THIS artifact's weights.
    # Not gated: reduced precision is a user choice, this prints its cost.
    p16 = {k: v.to(torch.bfloat16) for k, v in gp.items()}
    with torch.inference_mode():
        bf16_out = run_graph_torch(
            graph, {graph.inputs[0]: xt.to(torch.bfloat16)}, params=p16,
            compute_dtype=torch.bfloat16)[graph.outputs[0]]
    berr = np.abs(bf16_out.float().cpu().numpy() - got)
    print(f"bf16 serving drift (--precision fp16): "
          f"max {float(berr.max()):.3e}, "
          f"p99 {float(np.quantile(berr, 0.99)):.3e} "
          f"(u8 LSB = {1 / 255:.3e})")
    if args.save_npz:
        registry.save_params(args.save_npz, params)
        # record the passed gate next to the weights, keyed by their
        # content hash: Upscaler.load trusts it instead of warning that
        # converted-checkpoint fidelity is unverified
        sidecar = write_npz_verification(args.save_npz, {
            "source_onnx": str(args.onnx_path),
            "source_sha16": _sha16(args.onnx_path),
            "arch": derived.summary(),
            "max_err": err,
            "torch_serving_err": terr,
        })
        print(f"converted weights written to {args.save_npz} "
              f"(verification recorded in {sidecar.name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
