"""The chunked render pipeline and cross-frame tile streaming.

The port of ``waifu2x_tensorrt_tpu.engine.renderer`` (non-TTA, unpacked
head):

    uint8 frame -> [0,1] fp32 -> edge-pad + tile gather -> compute dtype
      -> model at batch-size chunks -> finalize (kernel C: blend,
         overlap-add in fp32 in ascending tile order, round-half-even x255,
         saturate to u8)

- ``ChunkedPipeline`` renders single frames: full batch-size chunks plus
  one exact-size remainder chunk;
- ``TileStream`` carries each frame's leftover tiles into the next frame's
  first chunk, so every model call in steady state is a full batch.

With a packed-x twin of the model (``WAIFU2X_PACK_X=1``, kernel D), every
geometry whose output x-origins are 16-aligned renders through it; its
(n, oh, ow/16, 48) chunk outputs hold the bytes of (n, oh, ow, 3), so
finalize views them as pixel tiles without a copy and runs kernel C as the
pixel path does.

Everything runs eagerly on the pipeline's device: prepare is one gather,
the model one ``nn.Module`` call per chunk, finalize one kernel-C launch
per frame (its plain scan twin on CPU). TTA, whole-frame tiles, the
executable store and sharding are not ported yet.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from waifu2x_tensorrt_tpu_torch.engine.config import RenderConfig
from waifu2x_tensorrt_tpu_torch.models.registry import ModelSpec
from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
    make_finalize_epilogue,
)
from waifu2x_tensorrt_tpu_torch.tiling import plan_tiles
from waifu2x_tensorrt_tpu_torch.utils.logging import Logger, Severity


def resolve_tile_plan(spec: ModelSpec, config: RenderConfig,
                      frame_hw: tuple[int, int]):
    """Tile plan for a frame (square tiles of ``config.height``)."""
    tile = config.height
    if tile == 0:
        raise NotImplementedError(
            "whole-frame rendering (--tileSize 0): not yet ported")
    if config.width != tile:
        raise ValueError("square tiles only (CLI parity)")
    out_tile = spec.output_tile(tile)
    return plan_tiles(frame_hw, (tile, tile), (out_tile, out_tile),
                      spec.scale, config.overlap)


def make_chunked_fns(spec: ModelSpec, config: RenderConfig,
                     frame_hw: tuple[int, int], device):
    """The model-independent halves of the chunked render for one frame
    geometry: ``prepare(frame_u8) -> chunks`` (with ``prepare.flat``, the
    unsplit (T, th, tw, 3) tiles), ``finalize(*outs) -> (H*s, W*s, 3) u8``,
    the plan and the chunk sizes. ``finalize`` runs kernel C on CUDA
    tensors and the plain scan on CPU tensors. With ``spec.pack_x > 1``
    it takes packed-x (n, oh, ow/pack_x, 3*pack_x) chunk outputs."""
    if config.tta:
        raise NotImplementedError("TTA: not yet ported")
    device = torch.device(device)
    plan = resolve_tile_plan(spec, config, frame_hw)
    n_steps = plan.tile_count
    chunk = config.batch_size
    n_full, rem = divmod(n_steps, chunk)
    chunk_sizes = [chunk] * n_full + ([rem] if rem else [])
    dtype = config.precision.dtype

    h, w = frame_hw
    pad_t, _pad_b, pad_l, _pad_r = plan.pad
    th, tw = plan.input_tile
    # edge-replicate pad + tile gather as ONE index gather: padded row r is
    # source row clamp(r - pad_t, 0, h - 1)
    rows = (plan.input_origins[:, 0:1] + np.arange(th)[None] - pad_t)
    cols = (plan.input_origins[:, 1:2] + np.arange(tw)[None] - pad_l)
    rows_t = torch.from_numpy(np.clip(rows, 0, h - 1)).to(device)
    cols_t = torch.from_numpy(np.clip(cols, 0, w - 1)).to(device)

    def prepare_flat(frame_u8: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) u8 -> (T, th, tw, 3) compute-dtype tiles."""
        x = frame_u8.to(torch.float32) * np.float32(1.0 / 255.0)
        tiles = x[rows_t[:, :, None], cols_t[:, None, :]]
        return tiles.to(dtype)

    def prepare(frame_u8: torch.Tensor):
        return prepare_flat(frame_u8).split(chunk_sizes)

    prepare.flat = prepare_flat
    finalize = make_finalize_epilogue(plan, device)
    if spec.pack_x > 1:
        if not pack_x_applicable(plan, spec.pack_x):
            raise ValueError("output x-origins are not pack_x-aligned "
                             "(gate with pack_x_applicable)")
        oh, ow = plan.output_tile
        finalize_pixels = finalize

        def finalize(*outs):
            # the packed-x layout's bytes are the pixel layout's: a view
            return finalize_pixels(*(o.view(o.shape[0], oh, ow, 3)
                                     for o in outs))
    return prepare, finalize, plan, chunk_sizes


def pack_x_applicable(plan, px: int) -> bool:
    """True when the geometry lets the packed-x model layout scatter
    exactly: output tile width and every output x-origin pack_x-aligned
    (at blend 1/16 tiles 128, 256 and 640 are, at either scale; 400 is
    not, nor is 64 at scale 2)."""
    return bool(px > 1 and plan.output_tile[1] % px == 0
                and np.all(plan.output_origins[:, 1] % px == 0))


def _as_frame(frame_u8, device) -> torch.Tensor:
    if isinstance(frame_u8, np.ndarray):
        frame_u8 = torch.from_numpy(np.require(frame_u8,
                                               requirements=["C", "W"]))
    if frame_u8.dtype != torch.uint8 or frame_u8.dim() != 3 \
            or frame_u8.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8 frame, got "
                         f"{frame_u8.dtype} {tuple(frame_u8.shape)}")
    return frame_u8.to(device)


class ChunkedPipeline:
    """Per-geometry prepare/finalize around one shared model.

    ``render`` runs chunk by chunk, firing ``progress(i, n, it_s)`` after
    each model chunk — the reference's "batch i/n @ it/s" seam
    (img2img_render.cpp:336-338). The returned u8 tensor stays on the
    device.

    ``module_pack_x`` (optional): the packed-x-head twin of ``module`` over
    the same parameters (``registry.packed_x_twin``), with its spec.
    Geometries whose output x-origins are pack_x-aligned render through
    it; the others through ``module`` (logged at debug level)."""

    def __init__(self, module, spec: ModelSpec, config: RenderConfig,
                 device, module_pack_x=None,
                 spec_pack_x: Optional[ModelSpec] = None,
                 logger: Optional[Logger] = None) -> None:
        self._module = module
        self._spec = spec
        self._config = config
        self._device = torch.device(device)
        self._module_px = module_pack_x
        self._spec_px = spec_pack_x if module_pack_x is not None else None
        self._logger = logger
        self._geoms: dict[tuple[int, int], tuple] = {}

    @property
    def config(self) -> RenderConfig:
        return self._config

    @property
    def device(self) -> torch.device:
        return self._device

    def get(self, frame_hw: tuple[int, int]):
        """(prepare, finalize, plan, n_chunks) for a frame geometry;
        ``prepare.use_pack_x`` says whether it renders through the
        packed-x twin."""
        key = (int(frame_hw[0]), int(frame_hw[1]))
        entry = self._geoms.get(key)
        if entry is None:
            spec_used = self._spec
            use_px = False
            if self._spec_px is not None:
                plan = resolve_tile_plan(self._spec, self._config, key)
                use_px = pack_x_applicable(plan, self._spec_px.pack_x)
                if use_px:
                    spec_used = self._spec_px
                elif self._logger is not None:
                    self._logger.log(
                        Severity.debug,
                        f"{key[0]}x{key[1]}: output x-origins not "
                        f"{self._spec_px.pack_x}-aligned; rendering "
                        "through the pixel head")
            prepare, finalize, plan, chunk_sizes = make_chunked_fns(
                spec_used, self._config, key, self._device)
            prepare.use_pack_x = use_px
            entry = (prepare, finalize, plan, len(chunk_sizes))
            self._geoms[key] = entry
        return entry

    def run_model(self, tiles: torch.Tensor,
                  use_pack_x: bool = False) -> torch.Tensor:
        module = self._module_px if use_pack_x else self._module
        with torch.inference_mode():
            return module(tiles)

    def render(self, frame_u8, progress=None) -> torch.Tensor:
        frame = _as_frame(frame_u8, self._device)
        prepare, finalize, _plan, n_chunks = self.get(frame.shape[:2])
        outs = []
        t_prev = time.perf_counter()
        with torch.inference_mode():
            for i, c in enumerate(prepare(frame)):
                outs.append(self.run_model(c, prepare.use_pack_x))
                if progress is not None:
                    t_now = time.perf_counter()
                    progress(i + 1, n_chunks,
                             1.0 / max(t_now - t_prev, 1e-9))
                    t_prev = t_now
            return finalize(*outs)


class TileStream:
    """Cross-frame tile streaming: the model runs at FULL batch, always.

    Leftover tiles of each frame ride in the next frame's first chunk; a
    frame's output is ready at most one chunk later and ``flush()`` drains
    the tail with one exact-size model call. One geometry per stream."""

    def __init__(self, pipeline: ChunkedPipeline, frame_hw: tuple[int, int],
                 progress=None) -> None:
        self._pl = pipeline
        self._progress = progress  # (i, n, it_s) per model chunk
        self._hw = (int(frame_hw[0]), int(frame_hw[1]))
        prep, fin, plan, _ = pipeline.get(self._hw)
        self._prep_flat = prep.flat
        self._use_px = prep.use_pack_x
        self._fin = fin
        self._n_steps = plan.tile_count
        self._chunk = pipeline.config.batch_size
        self._carry: Optional[torch.Tensor] = None  # (r, th, tw, 3) tiles
        self._outs: list = []        # [model output, rows consumed]
        self._pending = 0            # frames submitted, not yet finalized

    def _avail_out(self) -> int:
        return sum(int(a.shape[0]) - used for a, used in self._outs)

    def _drain(self) -> list:
        ready = []
        while self._pending and self._avail_out() >= self._n_steps:
            need = self._n_steps
            pieces = []
            while need:
                a, used = self._outs[0]
                take = min(need, int(a.shape[0]) - used)
                pieces.append(a[used:used + take])
                need -= take
                if used + take == int(a.shape[0]):
                    self._outs.pop(0)
                else:
                    self._outs[0][1] = used + take
            # finalize reads the pieces where they are (kernel C takes a
            # table of tile addresses): no concat
            with torch.inference_mode():
                ready.append(self._fin(*pieces))
            self._pending -= 1
        return ready

    def submit(self, frame_u8) -> list:
        """Feed one frame; returns the frame outputs (device u8 tensors, in
        submission order) that became ready."""
        frame = _as_frame(frame_u8, self._pl.device)
        if tuple(frame.shape[:2]) != self._hw:
            raise ValueError(f"stream expects {self._hw} frames, got "
                             f"{tuple(frame.shape[:2])}")
        with torch.inference_mode():
            tiles = self._prep_flat(frame)
            if self._carry is not None:
                tiles = torch.cat([self._carry, tiles], 0)
        self._pending += 1
        k = int(tiles.shape[0]) // self._chunk
        chunks = tiles[:k * self._chunk].split(self._chunk) if k else ()
        self._carry = tiles[k * self._chunk:] if tiles.shape[0] % self._chunk \
            else None
        t_prev = time.perf_counter()
        for i, c in enumerate(chunks):
            self._outs.append([self._pl.run_model(c, self._use_px), 0])
            if self._progress is not None:
                t_now = time.perf_counter()
                self._progress(i + 1, len(chunks),
                               1.0 / max(t_now - t_prev, 1e-9))
                t_prev = t_now
        return self._drain()

    def flush(self) -> list:
        """Run the carried tail (one exact-size model call) and return the
        remaining frame outputs."""
        if self._carry is not None:
            self._outs.append([self._pl.run_model(self._carry,
                                                  self._use_px), 0])
            self._carry = None
        return self._drain()

    def warm(self) -> int:
        """Run one carry cycle of zero frames through a throwaway stream
        (builds the kernels and warms the allocator and cuDNN's algorithm
        choice for every chunk split the stream will meet). Returns the
        number of warm frames."""
        cycle = (1 if self._n_steps % self._chunk == 0
                 else self._chunk // math.gcd(self._n_steps, self._chunk))
        throwaway = TileStream(self._pl, self._hw)
        frame = torch.zeros((*self._hw, 3), dtype=torch.uint8,
                            device=self._pl.device)
        for _ in range(cycle):
            throwaway.submit(frame)
        throwaway.flush()
        return cycle
