"""Command-line interface of the port: ``render`` of still images with the
reference's flags (src/main.cpp:17-154).

Ported: --model (cunet/art and the swin_unet families) --scale --noise
--batchSize --tileSize (64, 128, 256, 400, 640, and 0 for the whole frame
as one tile) --blend --tta --bucket --precision --device (an index, or
``cpu``) --models-dir --allow-random-weights, and ``render -i ... [-o DIR]
[--recursive] [--nosuffix]`` of image files. ``--precision tf32`` is full
fp32, as in the JAX package: the CLI turns torch's TF32 paths (cuDNN
convolutions, matmul) off for its process. The video flags ``--codec``,
``--pix_fmt`` and ``--crf`` are parsed with the reference's defaults and
accepted on still images, where they change nothing (the reference hands
``--crf`` to its PNG writer, which does not use it). The arguments are
validated as the JAX package's CLI validates them, in its order and with
its exit code -1 (model, --batchSize, --dp < 0, --tileSize auto with
``build``, --blend, --crf in [0, 51], the -o directory). Every other flag
or input of that CLI (``--tileSize auto``, ``--dp``, ``--multihost``,
``--alpha auto``, ``--continue-on-error``, video inputs, ``build``, ...)
is parsed and rejected with exit code 2 saying "not yet ported".
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from waifu2x_tensorrt_tpu_torch.engine.config import (
    TILE_CHOICES,
    Precision,
    RenderConfig,
)
from waifu2x_tensorrt_tpu_torch.io.discover import (
    DEFAULT_EXTENSIONS,
    IMAGE_EXTENSIONS,
    find_files_by_extension,
)
from waifu2x_tensorrt_tpu_torch.models.registry import (
    MODEL_FAMILIES,
    validate as validate_model,
)
from waifu2x_tensorrt_tpu_torch.utils.logging import (
    Severity,
    console_message_callback,
)

BLEND_CHOICES = (1 / 8, 1 / 16, 1 / 32, 0.0)  # src/main.cpp:108-115
NOT_PORTED = "not yet ported"


def _tile_size_arg(value: str):
    if value == "auto":
        return "auto"
    try:
        tile = int(value)
    except ValueError:
        tile = None
    if tile not in TILE_CHOICES:
        choices = ", ".join(str(t) for t in TILE_CHOICES)
        raise argparse.ArgumentTypeError(
            f"invalid choice: {value!r} (choose from {choices}, auto)")
    return tile


def _precision_arg(value: str) -> str:
    """Names and the reference's numeric enum values (src/main.cpp:76-84)."""
    mapped = {"fp16": "fp16", "tf32": "tf32", "1": "fp16", "0": "tf32"}
    if value not in mapped:
        raise argparse.ArgumentTypeError(
            f"invalid choice: {value!r} (choose from fp16, tf32, 1, 0)")
    return mapped[value]


def _device_arg(value: str):
    if value == "cpu":
        return "cpu"
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid device {value!r} (an index or 'cpu')") from None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="waifu2x-tpu-torch",
        description="waifu2x image upscaler (PyTorch/CUDA port)")
    p.add_argument("--model", required=True, choices=MODEL_FAMILIES)
    p.add_argument("--scale", required=True, type=int, choices=(1, 2, 4))
    p.add_argument("--noise", required=True, type=int,
                   choices=(-1, 0, 1, 2, 3))
    p.add_argument("--batchSize", dest="batch_size", required=True, type=int)
    p.add_argument("--tileSize", dest="tile_size", required=True,
                   type=_tile_size_arg)
    p.add_argument("--device", type=_device_arg, default=0,
                   help="CUDA device index, or 'cpu'")
    p.add_argument("--precision", type=_precision_arg, default="fp16")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--allow-random-weights", action="store_true",
                   dest="allow_random_weights")
    # flags of the JAX package's CLI that the port rejects for now
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--graph-exact", action="store_true", dest="graph_exact")

    sub = p.add_subparsers(dest="command", required=True)
    render = sub.add_parser("render", help="Render image(s)")
    render.add_argument("-i", "--input", dest="inputs", nargs="+",
                        action="extend", required=True)
    render.add_argument("--recursive", action="store_true")
    render.add_argument("-o", "--output", dest="output", default=None)
    render.add_argument("--nosuffix", action="store_true")
    render.add_argument("--blend", type=float, default=1 / 16)
    render.add_argument("--tta", action="store_true")
    render.add_argument("--codec", default="libx264")
    render.add_argument("--pix_fmt", default="yuv420p")
    render.add_argument("--crf", type=int, default=23)
    render.add_argument("--continue-on-error", action="store_true",
                        dest="continue_on_error")
    render.add_argument("--alpha", choices=("ignore", "auto"),
                        default="ignore")
    render.add_argument("--bucket", type=int, default=0)
    render.add_argument("--segment-frames", type=int, default=0,
                        dest="segment_frames")
    render.add_argument("--resume", action="store_true")
    render.add_argument("--profile", default=None)
    render.add_argument("--metrics-json", default=None, dest="metrics_json")
    sub.add_parser("build", help="Build model (not yet ported)")
    return p


def _unported(args) -> str | None:
    """The first requested feature the port does not have, or None."""
    if args.command == "build":
        return "build"
    checks = [
        (args.dp != 1, "--dp"),
        (args.multihost, "--multihost"),
        (args.graph_exact, "--graph-exact"),
        (args.tile_size == "auto", "--tileSize auto"),
        (args.alpha != "ignore", "--alpha auto"),
        (args.segment_frames != 0, "--segment-frames"),
        (args.resume, "--resume"),
        (args.continue_on_error, "--continue-on-error"),
        (args.profile is not None, "--profile"),
        (args.metrics_json is not None, "--metrics-json"),
    ]
    for hit, name in checks:
        if hit:
            return name
    return None


def output_suffix(model: str, noise: int, scale: int, tta: bool) -> str:
    """``(model)(noiseN)(scaleS)(tta)`` with '/'->'_' (src/main.cpp:205-209)."""
    s = f"({model.replace('/', '_')})"
    if noise != -1:
        s += f"(noise{noise})"
    if scale != 1:
        s += f"(scale{scale})"
    if tta:
        s += "(tta)"
    return s


def resolve_output_path(input_path: Path, output_dir: Path | None,
                        suffix: str, nosuffix: bool) -> Path:
    """Output naming of the render loop (src/main.cpp:240-255), images."""
    out = input_path
    if output_dir is not None:
        out = output_dir / out.name
    if not nosuffix:
        out = out.with_name(out.stem + suffix + out.suffix)
    return out.with_suffix(".png")


def _validate(args) -> None:
    """The JAX package's argument checks (its ``cli._validate``), in its
    order; each raises ValueError."""
    validate_model(args.model, args.scale, args.noise)
    if args.batch_size <= 0:
        raise ValueError("batchSize must be positive")
    if args.dp < 0:
        raise ValueError("--dp must be >= 0 (0 = all devices)")
    if args.tile_size == "auto" and args.command == "build":
        raise ValueError(
            "--tileSize auto requires the render subcommand (build "
            "compiles one concrete geometry; pass a numeric tile size)")
    if args.command == "render":
        if not any(abs(args.blend - c) < 1e-12 for c in BLEND_CHOICES):
            raise ValueError(
                f"--blend must be one of 1/8, 1/16, 1/32, 0; got {args.blend}")
        if not (0 <= args.crf <= 51):
            raise ValueError("--crf must be in [0, 51]")
        if args.output is not None and not Path(args.output).is_dir():
            raise ValueError(f"output directory does not exist: {args.output}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        _validate(args)
    except ValueError as e:
        print(e, file=sys.stderr)
        return -1
    feature = _unported(args)
    if feature is not None:
        print(f"{feature}: {NOT_PORTED}", file=sys.stderr)
        return 2

    message_cb = console_message_callback()
    files = find_files_by_extension(args.inputs, DEFAULT_EXTENSIONS,
                                    args.recursive)
    if not files:
        message_cb(Severity.error, "No input files found.")
        return -1
    videos = [f for f in files if f.suffix.lower() not in IMAGE_EXTENSIONS]
    if videos:
        message_cb(Severity.error,
                   f"video input {videos[0]}: {NOT_PORTED}")
        return 2

    from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
    from waifu2x_tensorrt_tpu_torch.io.image import read_image, write_image

    precision = Precision.FP16 if args.precision == "fp16" else Precision.TF32
    if precision is Precision.TF32:
        # "tf32" is full fp32 in both packages; torch's default would run
        # cuDNN's convolutions on TF32 tensor cores. The CLI owns its
        # process, so it sets the process-wide flags (a library caller
        # sets them itself).
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if args.device == "cpu" else f"cuda:{args.device}"
    config = RenderConfig(
        device_id=0 if args.device == "cpu" else args.device,
        precision=precision, batch_size=args.batch_size, channels=3,
        height=args.tile_size, width=args.tile_size, scaling=args.scale,
        overlap=(args.blend, args.blend), tta=args.tta)
    engine = Upscaler(models_dir=args.models_dir,
                      allow_random_init=args.allow_random_weights,
                      device=device)
    engine.set_message_callback(message_cb)
    state = {"file": 0}

    def progress_cb(current: int, total: int, speed: float) -> None:
        message_cb(Severity.info,
                   f"Rendered file {state['file']}/{len(files)}, "
                   f"batch {current}/{total} @ {speed:.2f} it/s")

    engine.set_progress_callback(progress_cb)
    try:
        engine.load(args.model, args.scale, args.noise, config,
                    bucket=args.bucket)
    except Exception as e:  # CLI boundary: report and exit non-zero
        message_cb(Severity.error, f"Engine load failed: {e}.")
        return -1

    suffix = output_suffix(args.model, args.noise, args.scale, args.tta)
    out_dir = Path(args.output) if args.output else None
    for i, file in enumerate(files):
        state["file"] = i + 1
        out_path = resolve_output_path(file, out_dir, suffix, args.nosuffix)
        try:
            write_image(out_path, engine.render(read_image(file)))
        except Exception as e:  # CLI boundary: report and exit non-zero
            message_cb(Severity.error, f"Render failed: {e}.")
            return -1
        message_cb(Severity.info, f"Wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
