"""The chunked render pipeline and cross-frame tile streaming.

The port of ``waifu2x_tensorrt_tpu.engine.renderer``:

    uint8 frame -> [0,1] fp32 -> edge-pad + tile gather -> compute dtype
      -> (x8 dihedral TTA) -> model at batch-size chunks
      -> (inverse-TTA fp32 mean) -> finalize (kernel C: blend, overlap-add
         in fp32 in ascending tile order, round-half-even x255, saturate
         to u8)

- ``ChunkedPipeline`` renders single frames: full batch-size chunks plus
  one exact-size remainder chunk;
- ``TileStream`` carries each frame's leftover tiles into the next frame's
  first chunk, so every model call in steady state is a full batch.

Tile plans are square tiles of ``config.height``, or with
``config.height == 0`` the whole frame as one (rectangular) tile that
includes the model's context (``resolve_tile_plan``). Under TTA each tile
runs as its 8 dihedral variants, variant-major (step ``i * T + t``); the
finalize inverts each variant in the compute dtype, casts to fp32, sums
in ascending variant order and scales by 1/8, then hands that fp32 mean
to kernel C as one chunk. A rectangular tile under TTA (whole-frame on a
non-square frame) batches its shape-preserving and its transposing
variants as two groups of chunks at two orientations; such a geometry has
no cross-frame stream.

With a packed-x twin of the model (``WAIFU2X_PACK_X=1``, kernel D), every
geometry whose output x-origins are 16-aligned renders through it; its
(n, oh, ow/16, 48) chunk outputs hold the bytes of (n, oh, ow, 3), so
finalize views them as pixel tiles without a copy and runs kernel C as the
pixel path does.

On the pipeline's device prepare is one gather, the model one program per
chunk, finalize one kernel-C launch per frame (its plain scan twin on
CPU); the TTA permutes and mean are plain torch ops, as they are
XLA-fused work in the JAX package. The model runs as the JAX package's
does, through the program store (``engine/exe_cache.py``): on CUDA each
chunk shape of the module (and of its packed-x twin) is one captured CUDA
graph, the graphs of a pipeline sharing one memory pool; on the CPU the
module is called. ``RendererCache`` (``fuse_frame``) makes a whole frame
one program (``make_render_fn``): one graph replay a frame. Frames go to
the card through pinned memory, without a synchronize. Sharding is not
ported.

Under a profiler session (``utils/profiling.py``) the stages are spans:
``w2x.prepare`` (upload, gather, cast, carry), ``w2x.model`` (a chunk
program), ``w2x.finalize`` (kernel C), each timed on the device's stream,
inside ``w2x.submit`` / ``w2x.flush`` when streamed. None is inside a
captured function, so the fused path's frame is unspanned.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Optional

import numpy as np
import torch

from waifu2x_tensorrt_tpu_torch.engine import exe_cache
from waifu2x_tensorrt_tpu_torch.engine.config import RenderConfig
from waifu2x_tensorrt_tpu_torch.models.registry import ModelSpec
from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
    make_finalize_epilogue,
)
from waifu2x_tensorrt_tpu_torch.tiling import (
    DIHEDRAL_SHAPE_PRESERVING,
    DIHEDRAL_SIZE,
    DIHEDRAL_TRANSPOSING,
    dihedral_apply,
    dihedral_inverse,
    plan_tiles,
)
from waifu2x_tensorrt_tpu_torch.utils import profiling
from waifu2x_tensorrt_tpu_torch.utils.logging import Logger, Severity


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_tile_plan(spec: ModelSpec, config: RenderConfig,
                      frame_hw: tuple[int, int]):
    """Tile plan for a frame: square tiles of ``config.height``, or with
    ``config.height == 0`` WHOLE-FRAME mode, the frame as one (rectangular)
    tile with no blend. An offset model (cunet's valid convs) loses
    2 * offset output pixels a tile, so the whole-frame tile includes
    ceil(2 * offset / scale) input pixels of context, rounded up to the
    model's tile divisor: one tile covers the whole output."""
    tile = config.height
    if tile == 0:
        d = spec.tile_divisor
        ctx = -(-2 * spec.offset // spec.scale)  # input space, both sides
        tile_hw = (_ceil_to(frame_hw[0] + ctx, d),
                   _ceil_to(frame_hw[1] + ctx, d))
    else:
        if config.width != tile:
            raise ValueError("square tiles only (CLI parity)")
        tile_hw = (tile, tile)
    out_tile_hw = (spec.output_tile(tile_hw[0]),
                   spec.output_tile(tile_hw[1]))
    return plan_tiles(frame_hw, tile_hw, out_tile_hw, spec.scale,
                      config.overlap)


def _tile_gather(plan, frame_hw, device):
    """``gather(frame_u8) -> (T, th, tw, 3)`` fp32 tiles in [0, 1]: the
    edge-replicate pad and the tile gather as ONE index gather (padded row
    r is source row clamp(r - pad_t, 0, h - 1))."""
    h, w = frame_hw
    pad_t, _pad_b, pad_l, _pad_r = plan.pad
    th, tw = plan.input_tile
    rows = (plan.input_origins[:, 0:1] + np.arange(th)[None] - pad_t)
    cols = (plan.input_origins[:, 1:2] + np.arange(tw)[None] - pad_l)
    rows_t = torch.from_numpy(np.clip(rows, 0, h - 1)).to(device)
    cols_t = torch.from_numpy(np.clip(cols, 0, w - 1)).to(device)

    def gather(frame_u8: torch.Tensor) -> torch.Tensor:
        x = frame_u8.to(torch.float32) * np.float32(1.0 / 255.0)
        return x[rows_t[:, :, None], cols_t[:, None, :]]

    return gather


def _inverse_sum(y: torch.Tensor, idxs) -> torch.Tensor:
    """sum over k, in order, of dihedral_inverse(y[k], idxs[k]) in fp32:
    each inverse in the compute dtype, cast at the accumulate (exact
    permutations commute with the cast)."""
    acc = dihedral_inverse(y[0], idxs[0]).float()
    for k in range(1, len(idxs)):
        acc = acc + dihedral_inverse(y[k], idxs[k]).float()
    return acc


def _chunk_sizes(n_steps: int, chunk: int) -> list[int]:
    """Full chunks plus one exact-size remainder."""
    n_full, rem = divmod(n_steps, chunk)
    return [chunk] * n_full + ([rem] if rem else [])


def make_chunked_fns(spec: ModelSpec, config: RenderConfig,
                     frame_hw: tuple[int, int], device):
    """The model-independent halves of the chunked render for one frame
    geometry: ``prepare(frame_u8) -> chunks`` (with ``prepare.flat``, the
    unsplit (steps, th, tw, 3) tiles, or None for a rect-TTA geometry),
    ``finalize(*outs) -> (H*s, W*s, 3) u8``, the plan and the chunk
    sizes. ``finalize`` runs kernel C on CUDA tensors and the plain scan
    on CPU tensors. With ``spec.pack_x > 1`` it takes packed-x
    (n, oh, ow/pack_x, 3*pack_x) chunk outputs (not under TTA)."""
    device = torch.device(device)
    plan = resolve_tile_plan(spec, config, frame_hw)
    if spec.pack_x > 1 and config.tta:
        raise ValueError(
            "packed heads are incompatible with TTA (dihedral inverses act "
            "in pixel space); create the model without head packing")
    if config.tta and plan.input_tile[0] != plan.input_tile[1]:
        return _make_rect_tta_chunked_fns(plan, config, frame_hw, device)
    T = plan.tile_count
    n_steps = T * (DIHEDRAL_SIZE if config.tta else 1)
    chunk_sizes = _chunk_sizes(n_steps, config.batch_size)
    dtype = config.precision.dtype
    gather = _tile_gather(plan, frame_hw, device)

    def prepare_flat(frame_u8: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) u8 -> (n_steps, th, tw, 3) compute-dtype tiles; under
        TTA variant-major (the permutes commute with the cast)."""
        tiles = gather(frame_u8).to(dtype)
        if config.tta:
            tiles = torch.cat([dihedral_apply(tiles, i)
                               for i in range(DIHEDRAL_SIZE)])
        return tiles

    def prepare(frame_u8: torch.Tensor):
        return prepare_flat(frame_u8).split(chunk_sizes)

    prepare.flat = prepare_flat
    prepare.chunk_sizes = chunk_sizes
    finalize = make_finalize_epilogue(plan, device)
    if config.tta:
        finalize_tiles = finalize
        oh, ow = plan.output_tile

        def finalize(*outs):
            y = torch.cat(outs)[:n_steps].reshape(DIHEDRAL_SIZE, T, oh, ow, 3)
            acc = _inverse_sum(y, range(DIHEDRAL_SIZE))
            return finalize_tiles(  # kernel C reads tiles by address
                (acc * np.float32(1.0 / DIHEDRAL_SIZE)).contiguous())
    elif spec.pack_x > 1:
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


def _make_rect_tta_chunked_fns(plan, config: RenderConfig, frame_hw,
                               device):
    """Chunked prepare/finalize for TTA over a RECTANGULAR tile
    (whole-frame on a non-square frame). The shape-preserving variants
    (identity, both flips, rot180) batch at (th, tw), the rot90 family at
    (tw, th); each group chunks on its own, and finalize inverts every
    variant back to (oh, ow) before the 1/8 mean, summing each group in
    its variant order and then the two group sums, as the JAX package
    does. ``prepare.flat`` is None: two orientations cannot ride one
    cross-frame carry."""
    dtype = config.precision.dtype
    half = DIHEDRAL_SIZE // 2
    T = plan.tile_count
    g_steps = T * half
    g_sizes = _chunk_sizes(g_steps, config.batch_size)
    chunk_sizes = g_sizes + g_sizes
    n_group = len(g_sizes)
    oh, ow = plan.output_tile
    gather = _tile_gather(plan, frame_hw, device)

    def prepare(frame_u8: torch.Tensor):
        tiles = gather(frame_u8).to(dtype)
        pieces = []
        for idxs in (DIHEDRAL_SHAPE_PRESERVING, DIHEDRAL_TRANSPOSING):
            g = torch.cat([dihedral_apply(tiles, i) for i in idxs])
            pieces.extend(g.split(g_sizes))
        return tuple(pieces)

    prepare.flat = None
    prepare.chunk_sizes = chunk_sizes
    finalize_tiles = make_finalize_epilogue(plan, device)

    def group_sum(outs, idxs, shape):
        y = torch.cat(outs)[:g_steps].reshape(half, T, *shape, 3)
        return _inverse_sum(y, idxs)

    def finalize(*outs):
        acc = (group_sum(outs[:n_group], DIHEDRAL_SHAPE_PRESERVING, (oh, ow))
               + group_sum(outs[n_group:], DIHEDRAL_TRANSPOSING, (ow, oh)))
        return finalize_tiles(  # kernel C reads tiles by address
            (acc * np.float32(1.0 / DIHEDRAL_SIZE)).contiguous())

    return prepare, finalize, plan, chunk_sizes


def pack_x_applicable(plan, px: int) -> bool:
    """True when the geometry lets the packed-x model layout scatter
    exactly: output tile width and every output x-origin pack_x-aligned
    (at blend 1/16 tiles 128, 256 and 640 are, at either scale; 400 is
    not, nor is 64 at scale 2)."""
    return bool(px > 1 and plan.output_tile[1] % px == 0
                and np.all(plan.output_origins[:, 1] % px == 0))


def _as_frame(frame_u8, device) -> torch.Tensor:
    """The (H, W, 3) u8 frame on ``device``. A host frame bound for a CUDA
    device is staged in pinned memory and copied without a synchronize (a
    pageable copy would drain the device's queue every frame); the caching
    host allocator records an event after the copy on the block it
    handed out and hands that block out again only once the event has
    passed."""
    if isinstance(frame_u8, np.ndarray):
        frame_u8 = torch.from_numpy(np.require(frame_u8,
                                               requirements=["C", "W"]))
    if frame_u8.dtype != torch.uint8 or frame_u8.dim() != 3 \
            or frame_u8.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8 frame, got "
                         f"{frame_u8.dtype} {tuple(frame_u8.shape)}")
    device = torch.device(device)
    if device.type == "cuda" and frame_u8.device.type == "cpu":
        staged = torch.empty(tuple(frame_u8.shape), dtype=torch.uint8,
                             pin_memory=True)
        staged.copy_(frame_u8)
        return staged.to(device, non_blocking=True)
    return frame_u8.to(device)


class ChunkedPipeline:
    """Per-geometry prepare/finalize around one shared model program.

    ``render`` runs chunk by chunk, firing ``progress(i, n, it_s)`` after
    each model chunk — the reference's "batch i/n @ it/s" seam
    (img2img_render.cpp:336-338). The returned u8 tensor stays on the
    device. The model runs through ``exe_cache.cached_program`` (tag
    ``model|<module_tag>``), as the JAX ``_make_model_prog`` does: one
    captured CUDA graph per chunk shape on CUDA, every graph of the
    pipeline in one memory pool.

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
        self.pool = exe_cache.GraphPool()
        self.model_prog = self._make_model_prog(module)
        self.model_prog_px = (self._make_model_prog(module_pack_x)
                              if module_pack_x is not None else None)
        self._flops: dict[tuple, float] = {}
        self._renders = 0

    def _make_model_prog(self, module):
        return exe_cache.cached_program(
            module, tag=f"model|{exe_cache.module_tag(module)}",
            pool=self.pool)

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
            if self._spec_px is not None and not self._config.tta:
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
        prog = self.model_prog_px if use_pack_x else self.model_prog
        return prog(tiles)

    def run_chunk(self, tiles: torch.Tensor, use_pack_x: bool,
                  frames: tuple[int, int]) -> torch.Tensor:
        """``run_model`` inside its ``w2x.model`` span; ``frames`` (first,
        last) are the frames the chunk's tiles belong to."""
        if not profiling.active():
            return self.run_model(tiles, use_pack_x)
        prog = self.model_prog_px if use_pack_x else self.model_prog
        with profiling.span("model", tiles.device, frames,
                            n=int(tiles.shape[0]),
                            **prog.trace_counts(tiles)):
            return self.run_model(tiles, use_pack_x)

    def flops_per_frame(self, frame_hw: tuple[int, int]) -> float:
        """Model FLOPs a frame at this geometry (the JAX package's
        ``ChunkedPipeline.flops_per_frame``, the MFU numerator): the
        products and convolutions of every chunk of the frame, at 2 FLOP a
        multiply-add, counted by ``FlopCounterMode`` on the module's plain
        path on the meta device (the CUDA kernels are opaque to the
        counter, their plain twins are not), once per chunk size. XLA's
        cost analysis also counts elementwise work, so this is 0.85-1.0 of
        the JAX count. Prepare and finalize are data movement and are not
        counted. Rect-TTA chunks count as (n, th, tw): the FLOPs of a
        product or a convolution depend on the pixel count, not the
        orientation."""
        prepare, _fin, plan, _n = self.get(frame_hw)
        module = self._module_px if prepare.use_pack_x else self._module
        th, tw = plan.input_tile
        total = 0.0
        for n in prepare.chunk_sizes:
            key = (prepare.use_pack_x, n, th, tw)
            if key not in self._flops:
                self._flops[key] = _plain_flops(
                    module, (n, th, tw, 3), self._config.precision.dtype)
            total += self._flops[key]
        return total

    def render(self, frame_u8, progress=None) -> torch.Tensor:
        frames = (self._renders, self._renders)
        self._renders += 1
        with profiling.span("prepare", self._device, frames):
            frame = _as_frame(frame_u8, self._device)
            prepare, finalize, _plan, n_chunks = self.get(frame.shape[:2])
            with torch.inference_mode():
                chunks = prepare(frame)
        outs = []
        t_prev = time.perf_counter()
        with torch.inference_mode():
            for i, c in enumerate(chunks):
                outs.append(self.run_chunk(c, prepare.use_pack_x, frames))
                if progress is not None:
                    t_now = time.perf_counter()
                    progress(i + 1, n_chunks,
                             1.0 / max(t_now - t_prev, 1e-9))
                    t_prev = t_now
            with profiling.span("finalize", self._device, frames,
                                pieces=len(outs)):
                return finalize(*outs)


def _plain_flops(module, shape, dtype) -> float:
    """FLOPs of one forward of ``module`` at ``shape``: a copy of it on the
    meta device (whose kernel wrappers run their plain twins) under
    ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(module).to("meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        meta(torch.empty(shape, dtype=dtype, device="meta"))
    return float(counter.get_total_flops())


def make_render_fn(module, spec: ModelSpec, config: RenderConfig,
                   frame_hw: tuple[int, int], device):
    """The whole render of one frame geometry as one function,
    ``fn(frame_u8) -> out_u8`` on ``device`` (the JAX
    ``make_render_fn``): u8 -> [0, 1], replicate pad and gather, every
    chunk (full chunks plus an exact-size remainder) through ``module``,
    TTA or rect TTA, and kernel C's finalize: ``make_chunked_fns``'s
    halves around the model. ``fn.plan`` and ``fn.n_chunks`` describe
    it."""
    prepare, finalize, plan, chunk_sizes = make_chunked_fns(
        spec, config, frame_hw, device)

    def fn(frame_u8: torch.Tensor) -> torch.Tensor:
        return finalize(*[module(c) for c in prepare(frame_u8)])

    fn.plan = plan
    fn.n_chunks = len(chunk_sizes)
    return fn


class RendererCache:
    """Whole-frame programs keyed by frame geometry (``fuse_frame``; the
    JAX ``RendererCache``): ``get(frame_hw)`` wraps ``make_render_fn`` in
    a ``CachedProgram`` tagged ``fused|<module_tag>|<spec>|<config>``,
    with the geometry in its key, so on CUDA a frame is one graph replay.
    One graph per frame size, all in one memory pool; no cross-frame
    stream and no per-chunk progress."""

    def __init__(self, module, spec: ModelSpec, config: RenderConfig,
                 device) -> None:
        self._module = module
        self._spec = spec
        self._config = config
        self._device = torch.device(device)
        self._tag = (f"fused|{exe_cache.module_tag(module)}|{spec}"
                     f"|{config}")
        self.pool = exe_cache.GraphPool()
        self._programs: dict[tuple[int, int], exe_cache.CachedProgram] = {}

    def get(self, frame_hw: tuple[int, int]) -> exe_cache.CachedProgram:
        key = (int(frame_hw[0]), int(frame_hw[1]))
        prog = self._programs.get(key)
        if prog is None:
            fn = make_render_fn(self._module, self._spec, self._config, key,
                                self._device)
            prog = exe_cache.cached_program(fn, tag=self._tag,
                                            pool=self.pool)
            prog.plan = fn.plan
            prog.n_chunks = fn.n_chunks
            self._programs[key] = prog
        return prog

    def render(self, frame_u8) -> torch.Tensor:
        """Render one frame; the u8 output stays on the device."""
        frame = _as_frame(frame_u8, self._device)
        return self.get(frame.shape[:2])(frame)


class TileStream:
    """Cross-frame tile streaming: the model runs at FULL batch, always.

    Leftover tiles of each frame ride in the next frame's first chunk; a
    frame's output is ready at most one chunk later and ``flush()`` drains
    the tail with one exact-size model call. One geometry per stream; under
    TTA a frame is 8 * T steps. A rect-TTA geometry (two tile
    orientations) cannot stream and raises ValueError."""

    def __init__(self, pipeline: ChunkedPipeline, frame_hw: tuple[int, int],
                 progress=None) -> None:
        self._pl = pipeline
        self._progress = progress  # (i, n, it_s) per model chunk
        self._hw = (int(frame_hw[0]), int(frame_hw[1]))
        prep, fin, plan, _ = pipeline.get(self._hw)
        self._prep_flat = prep.flat
        if self._prep_flat is None:
            raise ValueError(
                "TileStream unavailable for this geometry: rectangular-TTA "
                "whole-frame renders batch two tile orientations per frame "
                "and cannot ride one cross-frame carry; render per frame "
                "(ChunkedPipeline.render) instead")
        self._use_px = prep.use_pack_x
        self._fin = fin
        self._n_steps = plan.tile_count * (
            DIHEDRAL_SIZE if pipeline.config.tta else 1)
        self._chunk = pipeline.config.batch_size
        self._carry: Optional[torch.Tensor] = None  # (r, th, tw, 3) tiles
        self._outs: list = []        # [model output, rows consumed]
        self._pending = 0            # frames submitted, not yet finalized
        self._submitted = 0          # frames submitted; a frame's id is
        # its number here, and tile row g (counting every row the stream
        # ran) belongs to frame g // tiles a frame

    def _frames_of(self, row: int, n: int) -> tuple[int, int]:
        """The frames of rows ``row .. row + n - 1``."""
        return row // self._n_steps, (row + n - 1) // self._n_steps

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
            frame = self._submitted - self._pending
            with profiling.span("finalize", self._pl.device, (frame, frame),
                                pieces=len(pieces)), torch.inference_mode():
                ready.append(self._fin(*pieces))
            self._pending -= 1
        return ready

    def submit(self, frame_u8) -> list:
        """Feed one frame; returns the frame outputs (device u8 tensors, in
        submission order) that became ready."""
        n, chunk = self._n_steps, self._chunk
        frame_id = self._submitted
        carried = 0 if self._carry is None else int(self._carry.shape[0])
        row = frame_id * n - carried  # the stream's first row not yet run
        k = (carried + n) // chunk
        with profiling.span("submit", frames=(frame_id, frame_id), tiles=n,
                            carried=carried, chunks=k,
                            ready=(row + k * chunk) // n - row // n):
            with profiling.span("prepare", self._pl.device,
                                (row // n, frame_id)):
                frame = _as_frame(frame_u8, self._pl.device)
                if tuple(frame.shape[:2]) != self._hw:
                    raise ValueError(f"stream expects {self._hw} frames, "
                                     f"got {tuple(frame.shape[:2])}")
                with torch.inference_mode():
                    tiles = self._prep_flat(frame)
                    if self._carry is not None:
                        tiles = torch.cat([self._carry, tiles], 0)
            self._submitted += 1
            self._pending += 1
            chunks = tiles[:k * chunk].split(chunk) if k else ()
            self._carry = tiles[k * chunk:] if (carried + n) % chunk \
                else None
            t_prev = time.perf_counter()
            for i, c in enumerate(chunks):
                self._outs.append([self._pl.run_chunk(
                    c, self._use_px,
                    self._frames_of(row + i * chunk, chunk)), 0])
                if self._progress is not None:
                    t_now = time.perf_counter()
                    self._progress(i + 1, len(chunks),
                                   1.0 / max(t_now - t_prev, 1e-9))
                    t_prev = t_now
            return self._drain()

    def flush(self) -> list:
        """Run the carried tail (one exact-size model call) and return the
        remaining frame outputs."""
        tail = 0 if self._carry is None else int(self._carry.shape[0])
        with profiling.span("flush", tail=tail):
            if tail:
                row = self._submitted * self._n_steps - tail
                self._outs.append([self._pl.run_chunk(
                    self._carry, self._use_px, self._frames_of(row, tail)),
                    0])
                self._carry = None
            return self._drain()

    def warm(self) -> int:
        """Run one carry cycle of zero frames through a throwaway stream
        (builds the kernels and warms the allocator and cuDNN's algorithm
        choice for every chunk split the stream will meet, and captures the
        full chunk's program). Where programs are captured (CUDA), also run
        the model once at every tail that a flush can meet (each multiple of
        gcd(steps a frame, chunk) below the chunk), so that no capture
        falls inside the stream. Returns the number of warm frames."""
        step = math.gcd(self._n_steps, self._chunk)
        cycle = self._chunk // step
        throwaway = TileStream(self._pl, self._hw)
        frame = torch.zeros((*self._hw, 3), dtype=torch.uint8,
                            device=self._pl.device)
        for _ in range(cycle):
            throwaway.submit(frame)
        throwaway.flush()
        if exe_cache.enabled(self._pl.device):
            with torch.inference_mode():
                tile = self._prep_flat(frame)[:1]
            for n in range(step, self._chunk, step):
                self._pl.run_model(tile.new_zeros((n, *tile.shape[1:])),
                                   self._use_px)
        return cycle


def bucket_hw(frame_hw, bucket: int) -> tuple[int, int]:
    """(H, W) rounded up to multiples of ``bucket`` (unchanged for
    ``bucket <= 1``)."""
    h, w = int(frame_hw[0]), int(frame_hw[1])
    if bucket <= 1:
        return h, w
    return _ceil_to(h, bucket), _ceil_to(w, bucket)


def bucket_frame(frame_u8, bucket: int):
    """Edge-pad an (H, W, 3) frame (numpy array or torch tensor) at the
    bottom and right up to the next multiple of ``bucket``; returns
    (padded frame, original (H, W)). Mixed-size renders then meet a bounded
    number of geometries, at the cost of a thin strip of blend-boundary
    pixels near the padded edges (they blend with replicated content)."""
    h, w = int(frame_u8.shape[0]), int(frame_u8.shape[1])
    bh, bw = bucket_hw((h, w), bucket)
    ph, pw = bh - h, bw - w
    if not (ph or pw):
        return frame_u8, (h, w)
    if isinstance(frame_u8, np.ndarray):
        padded = np.pad(frame_u8, ((0, ph), (0, pw), (0, 0)), mode="edge")
    else:
        dev = frame_u8.device
        rows = torch.arange(h + ph, device=dev).clamp_(max=h - 1)
        cols = torch.arange(w + pw, device=dev).clamp_(max=w - 1)
        padded = frame_u8[rows][:, cols]
    return padded, (h, w)
