"""Command-line interface of the port: ``render`` of still images and
videos and ``build`` of engines, with the reference's flags
(src/main.cpp:17-154), the port of ``waifu2x_tensorrt_tpu.cli``.

Ported: --model (cunet/art and the swin_unet families) --scale --noise
--batchSize --tileSize (64, 128, 256, 400, 640, and 0 for the whole frame
as one tile) --blend --tta --bucket --precision --device (an index, or
``cpu``) --models-dir --allow-random-weights, and ``render -i ... [-o DIR]
[--recursive] [--nosuffix] [--codec] [--pix_fmt] [--crf] [--alpha auto]
[--segment-frames N] [--resume] [--continue-on-error] [--metrics-json
PATH] [--profile DIR]`` of image and video files, ``build`` (an engine
sidecar for the --batchSize x --tileSize profile; exit -1 with "Engine
build failed: ..."), and ``--graph-exact`` (a bare ``.onnx`` under
``models/<family>/`` serves through its own parsed graph instead of the
verified conversion). ``--precision tf32`` is full fp32, as in the JAX
package: the CLI turns torch's TF32 paths (cuDNN convolutions, matmul)
off for its process. The arguments are validated as the JAX package's CLI
validates them, in its order and with its exit code -1 (model,
--batchSize, --dp < 0, --tileSize auto with ``build``, --blend, --crf in
[0, 51], the -o directory), and ``build`` and the render loop give its
messages and exit codes. ``--dp``, ``--multihost`` and ``--tileSize auto``
are parsed and rejected with exit code 2 saying "not yet ported".

Device frames reach the writers through ``fetch_async``: each output's
copy into pinned host memory is queued behind its render, and the video
loop writes a submit's outputs after the next frame's work is queued.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from waifu2x_tensorrt_tpu_torch.engine.config import (
    TILE_CHOICES,
    BuildConfig,
    Precision,
    RenderConfig,
)
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler, fetch_async
from waifu2x_tensorrt_tpu_torch.io.discover import (
    DEFAULT_EXTENSIONS,
    find_files_by_extension,
)
from waifu2x_tensorrt_tpu_torch.io.video import (
    IMAGE_SUFFIXES,
    VideoCapture,
    VideoWriter,
)
from waifu2x_tensorrt_tpu_torch.models.registry import (
    MODEL_FAMILIES,
    validate as validate_model,
)
from waifu2x_tensorrt_tpu_torch.utils.logging import (
    Severity,
    console_message_callback,
)
from waifu2x_tensorrt_tpu_torch.utils.profiling import trace

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
        description="waifu2x image/video upscaler (PyTorch/CUDA port)")
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
    p.add_argument("--graph-exact", action="store_true", dest="graph_exact",
                   help="When serving a bare .onnx artifact, always run "
                        "the export's own parsed graph instead of the "
                        "verified conversion on the port's modules")
    # flags of the JAX package's CLI that the port rejects for now
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--multihost", action="store_true")

    sub = p.add_subparsers(dest="command", required=True)
    render = sub.add_parser("render", help="Render image(s)/video(s)")
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
    render.add_argument("--resume", action="store_true",
                        help="Skip inputs whose output file already exists")
    render.add_argument("--continue-on-error", action="store_true",
                        dest="continue_on_error",
                        help="Keep rendering remaining files after a "
                             "failure")
    render.add_argument("--profile", default=None, metavar="DIR",
                        help="Capture a torch.profiler trace into DIR")
    render.add_argument("--metrics-json", default=None, metavar="PATH",
                        dest="metrics_json",
                        help="Write a JSON render report: per-file wall "
                             "seconds and exit codes, run totals, and the "
                             "resolved configuration")
    render.add_argument("--bucket", type=int, default=0, metavar="N")
    render.add_argument("--segment-frames", type=int, default=0, metavar="N",
                        dest="segment_frames",
                        help="Render videos in N-frame segments (part files "
                             "stitched losslessly at the end); enables "
                             "frame-index --resume of an interrupted video")
    render.add_argument("--alpha", choices=("ignore", "auto"),
                        default="ignore",
                        help="'auto' upscales the alpha channel of a "
                             "transparent still through the same model and "
                             "writes RGBA PNG; 'ignore' keeps RGB only")
    sub.add_parser("build", help="Build model")
    return p


def _unported(args) -> str | None:
    """The first requested feature the port does not have, or None."""
    checks = [
        (args.dp != 1, "--dp"),
        (args.multihost, "--multihost"),
        (args.tile_size == "auto", "--tileSize auto"),
    ]
    for hit, name in checks:
        if hit:
            return name
    return None


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


def _open_stream(engine, frame_hw):
    """Streaming is an optional engine capability (None -> the caller
    uses the double-buffered per-frame loop). Warms one full carry cycle
    up front (``TileStream.warm``) so a live video doesn't stutter through
    first-call work at each chunk split in its first seconds."""
    opener = getattr(engine, "open_stream", None)
    stream = opener(frame_hw) if opener is not None else None
    if stream is not None:
        warm = getattr(stream, "warm", None)
        if warm is not None:
            warm()
    return stream


def _write_image(crf: int, out_path: Path, frame_u8: np.ndarray,
                 message_cb) -> int:
    """Write one finished still image through the PNG writer path
    (src/main.cpp:248-252: codec/pix_fmt empty, fps=1) with the
    zero-frame verification on release. The single writer protocol for
    both per-file renders and the image-stream batcher."""
    writer = VideoWriter()
    writer.set_constant_rate_factor(crf)
    writer.set_frame_rate(1).set_pixel_format("").set_codec("")
    writer.set_frame_size(frame_u8.shape[1], frame_u8.shape[0])
    writer.set_output_file(out_path)
    rc = 0
    try:
        writer.open()
        writer.write(frame_u8)
    except Exception as e:
        message_cb(Severity.error, f"Render failed: {e}.")
        rc = -1
    finally:
        try:
            writer.release()
        except Exception as e:
            if rc == 0:
                message_cb(Severity.error, f"Render failed: {e}.")
                rc = -1
    if rc == 0:
        message_cb(Severity.info, f"Wrote {out_path}")
    return rc


class _ImageStreamBatcher:
    """Cross-file tile streaming for still images.

    The reference renders each image independently and pads the final
    model batch with zero tiles (img2img_render.cpp:281) — a 512x512
    image at tile 256 fills 9 slots of a 16-tile batch. Here, runs of
    same-size images share one cross-frame ``TileStream`` (the video hot
    path): leftover tiles of each image ride in the next image's chunk,
    so every model call stays full-batch across FILES. Outputs trail
    submission by at most one chunk and are written (and verified) in
    submission order through the same PNG writer path as per-file
    renders. A chunk that spans files runs at full batch where the
    per-image path would have run an exact-size remainder, which may
    round differently (within the golden gate).

    Because writes are deferred, a failure writing image A can surface
    while a later file is being read; the error message names A's
    output path. Progress callbacks fired by a boundary chunk may
    likewise be attributed to the next file."""

    def __init__(self, args, engine, message_cb) -> None:
        self._args = args
        self._engine = engine
        self._cb = message_cb
        self._stream = None
        self._hw = None
        self._pending = deque()  # (out_path, raw frame) awaiting outputs

    def submit(self, frame_u8: np.ndarray, out_path: Path) -> int:
        """Queue one decoded image; write whatever renders complete.
        A geometry change flushes the previous run first. Returns 0/-1."""
        hw = (int(frame_u8.shape[0]), int(frame_u8.shape[1]))
        rc = 0
        if self._stream is None or hw != self._hw:
            rc = self.drain()
            if rc != 0 and not self._args.continue_on_error:
                return rc
            stream = _open_stream(self._engine, hw)
            if stream is None:  # a rect-TTA geometry: no stream
                try:
                    out = np.asarray(self._engine.render(frame_u8))
                except Exception as e:
                    self._cb(Severity.error, f"Render failed: {e}.")
                    return -1
                wrc = self._write_one(Path(out_path), out)
                return wrc if wrc != 0 else rc
            self._stream = stream
            self._hw = hw
        self._pending.append((Path(out_path), frame_u8))
        try:
            outs = self._stream.submit(frame_u8)
        except Exception as e:
            return self._salvage(e)
        wrc = self._write(outs)
        return wrc if wrc != 0 else rc

    def drain(self) -> int:
        """Flush the open stream and write every pending image."""
        if self._stream is None:
            return 0
        stream, self._stream, self._hw = self._stream, None, None
        try:
            outs = stream.flush()
        except Exception as e:
            return self._salvage(e)
        rc = self._write(outs)
        if self._pending:  # contract: flush yields one output per input
            return self._salvage(
                RuntimeError("stream flushed fewer outputs than inputs"))
        return rc

    def _write(self, outs) -> int:
        # every output must be consumed even after a write failure:
        # stopping mid-batch would leave _pending misaligned, and a later
        # drain would write the NEXT image's pixels to this image's path.
        # The remaining outputs are already computed, so writing them is
        # strictly better than dropping them regardless of
        # --continue-on-error (the nonzero rc still stops the RUN there).
        rc = 0
        for out in [fetch_async(o) for o in outs]:  # every copy queued first
            out_path, _ = self._pending.popleft()
            if self._write_one(out_path, np.asarray(out)) != 0:
                rc = -1
        return rc

    def _write_one(self, out_path: Path, frame_u8: np.ndarray) -> int:
        return _write_image(self._args.crf, out_path, frame_u8, self._cb)

    def _salvage(self, exc: Exception) -> int:
        """Stream failure: report it, then re-render every pending image
        through the per-image path (the same kernels) so already-read
        files are not lost. The run still fails (-1)."""
        self._cb(
            Severity.error,
            f"Image stream failed ({exc}); re-rendering "
            f"{len(self._pending)} pending image(s) individually.")
        self._stream = None
        self._hw = None
        while self._pending:
            out_path, frame = self._pending.popleft()
            try:
                out = np.asarray(self._engine.render(frame))
            except Exception as e:
                self._cb(Severity.error, f"Render failed: {e}.")
                continue
            self._write_one(out_path, out)
        return -1


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
                        suffix: str, nosuffix: bool,
                        is_image: bool) -> Path:
    """Output naming rules of the render loop (src/main.cpp:240-255)."""
    out = input_path
    if output_dir is not None:
        out = output_dir / out.name
    if not nosuffix:
        out = out.with_name(out.stem + suffix + out.suffix)
    return out.with_suffix(".png" if is_image else ".mp4")


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
    precision = Precision.FP16 if args.precision == "fp16" else Precision.TF32
    if precision is Precision.TF32:
        # "tf32" is full fp32 in both packages; torch's default would run
        # cuDNN's convolutions on TF32 tensor cores. The CLI owns its
        # process, so it sets the process-wide flags (a library caller
        # sets them itself).
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if args.device == "cpu" else f"cuda:{args.device}"
    device_id = 0 if args.device == "cpu" else args.device
    engine = Upscaler(models_dir=args.models_dir,
                      allow_random_init=args.allow_random_weights,
                      device=device)
    engine.set_message_callback(message_cb)

    if args.command == "build":
        tile, batch = args.tile_size, args.batch_size
        config = BuildConfig(
            device_id=device_id, precision=precision,
            min_batch_size=batch, opt_batch_size=batch,
            max_batch_size=batch, min_width=tile, opt_width=tile,
            max_width=tile, min_height=tile, opt_height=tile,
            max_height=tile)
        try:
            engine.build(args.model, args.scale, args.noise, config,
                         graph_exact=args.graph_exact)
        except Exception as e:  # CLI boundary: report and exit non-zero
            message_cb(Severity.error, f"Engine build failed: {e}.")
            return -1
        return 0

    files = find_files_by_extension(args.inputs, DEFAULT_EXTENSIONS,
                                    args.recursive)
    if not files:
        message_cb(Severity.error, "No input files found.")
        return -1

    config = RenderConfig(
        device_id=device_id, precision=precision,
        batch_size=args.batch_size, channels=3, height=args.tile_size,
        width=args.tile_size, scaling=args.scale,
        overlap=(args.blend, args.blend), tta=args.tta)
    state = {"file": 0, "files": len(files), "frame": 0, "frames": 0}

    def progress_cb(current: int, total: int, speed: float) -> None:
        message_cb(
            Severity.info,
            f"Rendered file {state['file']}/{state['files']}, "
            f"frame {state['frame']}/{state['frames']}, "
            f"batch {current}/{total} @ {speed:.2f} it/s")

    engine.set_progress_callback(progress_cb)
    try:
        engine.load(args.model, args.scale, args.noise, config,
                    bucket=args.bucket, graph_exact=args.graph_exact)
    except Exception as e:  # CLI boundary: report and exit non-zero
        message_cb(Severity.error, f"Engine load failed: {e}.")
        return -1

    suffix = output_suffix(args.model, args.noise, args.scale, args.tta)
    out_dir = Path(args.output) if args.output else None

    # Two or more still images in the worklist: stream them through one
    # cross-file TileStream so image boundaries never pad a model batch
    # (see _ImageStreamBatcher; single images keep the leaner inline path).
    n_images = sum(1 for f in files
                   if Path(f).suffix.lower() in IMAGE_SUFFIXES)
    batcher = (_ImageStreamBatcher(args, engine, message_cb)
               if n_images > 1 and engine.can_stream else None)

    metrics = None
    if args.metrics_json:
        metrics = {
            "config": {
                "model": args.model, "scale": args.scale,
                "noise": args.noise, "tile_size": args.tile_size,
                "batch_size": args.batch_size,
                "precision": args.precision, "tta": args.tta,
                "blend": args.blend, "dp": args.dp,
                "streamed_images": batcher is not None,
            },
            "files": [],
        }
    t_run0 = time.perf_counter()

    exit_code = 0
    drain_rc = 0
    capture = VideoCapture()
    try:
        with trace(args.profile):
            for file_index, file in enumerate(files):
                state["file"] = file_index + 1
                state["frames"] = 0  # else a failed open inherits the
                t0 = time.perf_counter()  # previous file's count
                rc = _render_one(args, engine, capture, file, out_dir,
                                 suffix, state, message_cb, batcher)
                if metrics is not None:
                    # with cross-file image streaming, a file's tail tiles
                    # render (and write) during the NEXT file's slot —
                    # per-file seconds are attribution, totals are exact.
                    # frames is -1 for unknown-length streams ("?").
                    n = state["frames"]
                    metrics["files"].append({
                        "input": str(file), "rc": rc,
                        "frames": n if isinstance(n, int) else -1,
                        "seconds": round(time.perf_counter() - t0, 3),
                    })
                if rc != 0:
                    if not args.continue_on_error:
                        if batcher is not None:
                            batcher.drain()  # salvage already-read images
                        exit_code = rc
                        return rc
                    exit_code = rc
            if batcher is not None:
                drain_rc = batcher.drain()
                if drain_rc != 0:
                    exit_code = drain_rc
        return exit_code
    finally:
        if metrics is not None:
            # an exception (Ctrl-C, a raise inside trace()/the stream)
            # lands here with exit_code still holding its pre-crash value
            # — the report must not read as a clean run
            aborted = sys.exc_info()[0] is not None
            metrics["totals"] = {
                "files": len(metrics["files"]),
                "failed": sum(1 for f in metrics["files"] if f["rc"] != 0),
                "wall_seconds": round(time.perf_counter() - t_run0, 3),
                "exit_code": exit_code if not aborted else (exit_code or -1),
            }
            if aborted:
                metrics["totals"]["aborted"] = True
            if drain_rc != 0:
                # deferred stream writes that failed at the final drain
                # belong to no per-file row (their submit already returned
                # 0) — surface them so failed==0 + exit_code!=0 is
                # explained inside the report itself
                metrics["totals"]["deferred_write_failures"] = True
            try:
                Path(args.metrics_json).write_text(
                    json.dumps(metrics, indent=2))
            except OSError as e:
                message_cb(Severity.warn,
                           f"could not write metrics report: {e}")


def _frames(capture):
    """Yield the capture's frames; an unknown count (frame_count < 0,
    streams without nb_frames) reads to EOF in ONE decode pass, a known
    count that ends early is an error."""
    n = capture.frame_count
    i = 0
    while n < 0 or i < n:
        frame = capture.read()
        if frame is None:
            if n < 0:
                return
            raise RuntimeError("decoder ended early")
        i += 1
        yield frame


def _stream_frames(engine, writer, hw, frames, on_index) -> None:
    """Pump decoded frames through the engine into the writer — the ONE
    streaming video loop both the plain and the segmented paths share.
    Cross-frame tile streaming (``Upscaler.open_stream``) keeps every
    model call at full batch; a submit's outputs are written after the
    next frame's work is queued, so encoding overlaps the device. Falls
    back to the double-buffered per-frame loop (``render_async``) when
    streaming does not apply."""
    stream = _open_stream(engine, hw)
    if stream is not None:
        ready = []
        for i, frame in enumerate(frames):
            on_index(i)
            done, ready = ready, [fetch_async(o) for o in stream.submit(frame)]
            for out in done:
                writer.write(np.asarray(out))
        for out in ready + [fetch_async(o) for o in stream.flush()]:
            writer.write(np.asarray(out))
    else:
        pending = None
        for i, frame in enumerate(frames):
            on_index(i)
            fut = engine.render_async(frame)
            if pending is not None:
                writer.write(np.asarray(pending))
            pending = fut
        if pending is not None:  # empty input: nothing in flight
            writer.write(np.asarray(pending))


def _render_rgba(args, engine, file, out_path, state, message_cb):
    """Alpha-aware still-image render (``--alpha auto``; extension — the
    reference's pipes are rgb24-only, src/videoio/capture.cpp:55 carries a
    literal alpha-support TODO). Returns None when the file has no alpha
    channel (callers continue on the normal RGB path).

    The RGB planes are upscaled after bleeding opaque colors under the
    transparent region (io/image.fill_transparent — prevents dark halos at
    alpha edges), and the alpha plane rides through the SAME loaded model
    as a grayscale frame (identical geometry); the recombined RGBA goes
    out as PNG. The alpha plane's channel mean is taken on the host in
    numpy, in the reference's order of summation."""
    from waifu2x_tensorrt_tpu_torch.io.image import (
        fill_transparent,
        read_rgba,
        write_image,
    )

    try:
        rgb, a = read_rgba(file)
    except Exception:
        return None  # normal capture path owns decode-error reporting
    if a is None:
        return None
    state["frames"] = 1
    state["frame"] = 1
    try:
        rgb = fill_transparent(rgb, a)
        # both planes are queued before either fetch
        out_f = engine.render_async(rgb)
        a_f = engine.render_async(np.repeat(a[:, :, None], 3, axis=2))
        out = np.asarray(out_f)
        a_up = np.clip(
            np.rint(np.asarray(a_f).astype(np.float32).mean(axis=2)),
            0, 255).astype(np.uint8)
        write_image(out_path, np.dstack([out, a_up]))
    except Exception as e:
        message_cb(Severity.error, f"Render failed: {e}.")
        return -1
    message_cb(Severity.info, f"Wrote {out_path}")
    return 0


def _render_one(args, engine, capture, file, out_dir, suffix, state,
                message_cb, batcher=None) -> int:
    try:
        capture.open(file)
    except Exception as e:
        message_cb(Severity.error, f"Failed to open {file}: {e}.")
        return -1
    is_image = capture.frame_count == 1
    out_path = resolve_output_path(file, out_dir, suffix, args.nosuffix,
                                   is_image)
    if getattr(args, "resume", False) and out_path.exists():
        message_cb(Severity.info, f"Skipping {file} (output exists)")
        capture.release()
        return 0
    if is_image and getattr(args, "alpha", "ignore") == "auto":
        rc_a = _render_rgba(args, engine, file, out_path, state, message_cb)
        if rc_a is not None:  # file HAD alpha: fully handled
            capture.release()
            return rc_a
    rc0 = 0
    if batcher is not None:
        if is_image:
            rc = 0
            try:
                frame = capture.read()
                if frame is None:
                    raise RuntimeError("decoder ended early")
                state["frames"] = 1
                state["frame"] = 1
                src = batcher.submit(frame, out_path)
                rc = src if src != 0 else rc
            except Exception as e:
                message_cb(Severity.error, f"Render failed: {e}.")
                rc = -1
            finally:
                capture.release()
            return rc
        # a video ends the image run: flush pending image outputs first
        rc0 = batcher.drain()
        if rc0 != 0 and not args.continue_on_error:
            capture.release()
            return rc0
    if not is_image and getattr(args, "segment_frames", 0) > 0:
        total = capture.frame_count
        fps = capture.frame_rate
        capture.release()
        if total < 0:
            # segment grids need the exact count; pay the counting decode
            # only on this path (ordinary renders stream to EOF instead).
            # Missing ffprobe / probe failure must follow the normal
            # error protocol (rc=-1 + message), not a raw traceback.
            try:
                total = capture._count_frames(Path(file))
            except Exception as e:
                message_cb(Severity.error,
                           f"Cannot determine frame count of {file} for "
                           f"segmented rendering: {e}.")
                return -1
        rc = _render_video_segmented(args, engine, file, out_path, state,
                                     message_cb, total, fps)
        return rc if rc != 0 else rc0
    state["frames"] = capture.frame_count if capture.frame_count > 0 else "?"
    if is_image:
        # single still without a batcher: render, then write through the
        # same PNG writer protocol the batcher uses
        rc = 0
        out = None
        try:
            frame = capture.read()
            if frame is None:
                raise RuntimeError("decoder ended early")
            state["frame"] = 1
            out = np.asarray(engine.render(frame))
        except Exception as e:
            message_cb(Severity.error, f"Render failed: {e}.")
            rc = -1
        finally:
            capture.release()
        if rc == 0:
            rc = _write_image(args.crf, out_path, out, message_cb)
        return rc if rc != 0 else rc0

    writer = VideoWriter()
    writer.set_constant_rate_factor(args.crf)
    writer.set_frame_rate(capture.frame_rate) \
          .set_pixel_format(args.pix_fmt).set_codec(args.codec)
    writer.set_frame_size(capture.frame_width * args.scale,
                          capture.frame_height * args.scale)
    writer.set_output_file(out_path)

    rc = 0
    try:
        writer.open()
        _stream_frames(
            engine, writer,
            (capture.frame_height, capture.frame_width),
            _frames(capture),
            on_index=lambda i: state.__setitem__("frame", i + 1))
    except Exception as e:
        message_cb(Severity.error, f"Render failed: {e}.")
        rc = -1
    finally:
        capture.release()
        try:
            # release() verifies the output was actually produced (image
            # mode: at least one frame written; native pipe: encoder
            # drained cleanly) and raises otherwise.
            writer.release()
        except Exception as e:
            if rc == 0:
                message_cb(Severity.error, f"Render failed: {e}.")
                rc = -1
    if rc != 0:
        return rc
    message_cb(Severity.info, f"Wrote {out_path}")
    return rc0


def _render_video_segmented(args, engine, file, out_path, state, message_cb,
                            total_frames, frame_rate) -> int:
    """Segmented video render: mid-video resume.

    The segment grid is a pure function of (video, flags), so every
    resumed run derives identical part boundaries. Each segment decodes
    only its frame window (frame-exact trim), encodes to an
    atomically-published part file, and the last finisher stitches the
    parts losslessly (the reference restarts videos from frame 0).
    """
    from waifu2x_tensorrt_tpu_torch.io.video import (
        concat_segments,
        segment_grid,
        segment_path,
    )

    grid = segment_grid(total_frames, getattr(args, "segment_frames", 0))
    state["frames"] = total_frames
    for a, b in grid:
        part = segment_path(out_path, a, b)
        if getattr(args, "resume", False) and part.exists():
            message_cb(Severity.info,
                       f"Skipping frames [{a}, {b}) (segment exists)")
            continue
        tmp = part.with_name(part.stem + ".tmp" + part.suffix)
        capture = VideoCapture()
        writer = None
        try:
            # capture.open inside the try: a bad frame_range / probe
            # failure must follow the same error protocol, not escape as
            # a raw traceback
            capture.open(file, frame_range=(a, b))
            writer = (VideoWriter()
                      .set_constant_rate_factor(args.crf)
                      .set_frame_rate(frame_rate)
                      .set_pixel_format(args.pix_fmt).set_codec(args.codec)
                      .set_frame_size(capture.frame_width * args.scale,
                                      capture.frame_height * args.scale)
                      .set_output_file(tmp))
            writer.open()

            # the SAME streaming loop as the unsegmented path; the stream
            # is flushed at the segment boundary so part files stay exact
            def seg_frames():
                for _ in range(b - a):
                    frame = capture.read()
                    if frame is None:
                        raise RuntimeError("decoder ended early")
                    yield frame

            _stream_frames(
                engine, writer,
                (capture.frame_height, capture.frame_width),
                seg_frames(),
                on_index=lambda i: state.__setitem__("frame", a + i + 1))
            capture.release()
            # on the success path release() is part of the contract: it
            # verifies the encoder drained and exited cleanly, and raises
            # (into the except below) otherwise
            writer.release()
        except Exception as e:
            message_cb(Severity.error,
                       f"Render failed in frames [{a}, {b}): {e}.")
            for closer in (capture, writer):
                try:
                    if closer is not None:
                        closer.release()  # idempotent on both classes
                except Exception:
                    pass
            tmp.unlink(missing_ok=True)
            return -1
        tmp.replace(part)  # atomic: existence == segment complete
        message_cb(Severity.info,
                   f"Rendered segment [{a}, {b}) -> {part.name}")

    expected = [segment_path(out_path, a, b) for a, b in grid]
    # An O_EXCL lock file picks exactly one stitcher when several
    # processes render into one directory (the losers report and exit 0;
    # the winner publishes the final file atomically and removes the
    # lock). A process that dies mid-stitch leaves the lock behind; the
    # message names it as the manual recovery (parts are still on disk,
    # so deleting the lock and rerunning --resume re-stitches).
    lock = out_path.with_name(out_path.name + ".stitch.lock")
    try:
        fd = os.open(str(lock), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except FileExistsError:
        if out_path.exists():  # a previous winner already published
            return 0
        message_cb(Severity.info,
                   f"{out_path.name}: another host holds the stitch "
                   f"lock ({lock.name}); if it crashed, delete the "
                   "lock and rerun with --resume")
        return 0
    try:
        concat_segments(expected, out_path, frame_rate)
        for p in expected:
            p.unlink(missing_ok=True)
    except Exception as e:
        # stitch failures follow the same error protocol as renders — a
        # raw CalledProcessError would abort remaining files even under
        # --continue-on-error
        message_cb(Severity.error,
                   f"Failed to stitch {out_path.name}: {e}.")
        return -1
    finally:
        lock.unlink(missing_ok=True)
    message_cb(Severity.info, f"Wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
