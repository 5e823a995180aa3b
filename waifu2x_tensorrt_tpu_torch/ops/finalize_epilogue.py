"""Kernel C: the gather finalize (blend + overlap-add + u8 in one pass).

``finalize_gather`` is the wrapper of the CUDA kernel
``csrc/finalize_epilogue.cu`` (the port of the TPU kernel
``waifu2x_tensorrt_tpu.ops.finalize_epilogue.make_finalize_epilogue``);
``finalize_scan`` is its plain PyTorch twin, the per-tile scan of
``waifu2x_tensorrt_tpu.engine.renderer.make_chunked_fns`` (renderer.py
:413-483): each tile's output times its row and column ramps is added onto
an fp32 canvas in ascending tile order, then clip(round(x * 255)) -> u8.
The kernel computes every output element with the same fp32 operations in
the same order, so the two are byte-identical.

``make_finalize_epilogue(plan, device)`` builds the per-geometry
``finalize(*outs)``: the ramps are uploaded once, and each call takes the
model's chunk outputs (or TileStream's pieces of them) where they are.
Each call's table of tile addresses goes to the card from pinned memory
without a synchronize, so finalize never makes the host wait for the
chunks it reads.
"""

from __future__ import annotations

import numpy as np
import torch

from waifu2x_tensorrt_tpu_torch.ops import build


def grid_geometry(plan):
    """(R, C, sy, sx) of a uniform column-major tile grid (tile
    t = col * R + row), or None when the plan is not one. A single row or
    column gets the tile size as its stride."""
    T = plan.tile_count
    oh, ow = plan.output_tile
    ys = np.unique(plan.output_origins[:, 0])
    xs = np.unique(plan.output_origins[:, 1])
    R, C = len(ys), len(xs)
    if R * C != T:
        return None
    got = plan.output_origins.reshape(C, R, 2)
    if not (np.array_equal(got[:, :, 0], np.tile(ys, (C, 1)))
            and np.array_equal(got[:, :, 1], xs[:, None].repeat(R, 1))):
        return None
    sy = int(ys[1] - ys[0]) if R > 1 else oh
    sx = int(xs[1] - xs[0]) if C > 1 else ow
    if ys[0] != 0 or xs[0] != 0:
        return None
    if not (np.all(np.diff(ys) == sy) and np.all(np.diff(xs) == sx)):
        return None
    return R, C, sy, sx


def epilogue_applicable(plan) -> bool:
    """The kernel's contract, geometric only: a uniform grid whose tiles
    overlap their neighbours by at most one stride (so <= 2 tiles cover a
    row or column of pixels)."""
    g = grid_geometry(plan)
    if g is None:
        return False
    _R, _C, sy, sx = g
    oh, ow = plan.output_tile
    return 0 < sy <= oh <= 2 * sy and 0 < sx <= ow <= 2 * sx


def finalize_scan(outs, plan):
    """Plain twin: the renderer's per-tile scan finalize on (n, oh, ow, 3)
    chunk outputs (any split into pieces); returns (H, W, 3) u8."""
    oh, ow = plan.output_tile
    out_h, out_w = plan.output_size
    canvas_h, canvas_w = plan.canvas_size
    dev = outs[0].device
    rw = torch.from_numpy(plan.row_weights).to(dev)
    cw = torch.from_numpy(plan.col_weights).to(dev)
    canvas = torch.zeros((canvas_h, canvas_w, 3), dtype=torch.float32,
                         device=dev)
    t = 0
    for c in outs:
        for i in range(int(c.shape[0])):
            if t == plan.tile_count:
                break
            y, x = (int(v) for v in plan.output_origins[t])
            tile = c[i].float() * rw[t][:, None, None] * cw[t][None, :, None]
            canvas[y:y + oh, x:x + ow] += tile
            t += 1
    if t != plan.tile_count:
        raise ValueError(f"finalize got {t} tiles, plan has "
                         f"{plan.tile_count}")
    out = canvas[:out_h, :out_w]
    return torch.clamp(torch.round(out * 255.0), 0.0, 255.0).to(torch.uint8)


def finalize_gather(tile_ptrs, row_w, col_w, out, geom, is_bf16: bool):
    """Launch kernel C. ``tile_ptrs`` (T,) int64 device table of tile base
    addresses; ``row_w`` (T, oh) / ``col_w`` (T, ow) fp32 ramps; ``out``
    the (H, W, 3) u8 frame, written in place; ``geom`` (R, C, sy, sx, oh,
    ow). Counts kernel launches in ``finalize_gather.launches``."""
    R, C, sy, sx, oh, ow = geom
    out_h, out_w = int(out.shape[0]), int(out.shape[1])
    for name, t in (("tile_ptrs", tile_ptrs), ("row_w", row_w),
                    ("col_w", col_w), ("out", out)):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if tile_ptrs.dtype != torch.int64 or tile_ptrs.shape != (R * C,):
        raise ValueError("tile_ptrs must be (T,) int64")
    if (tuple(row_w.shape) != (R * C, oh) or tuple(col_w.shape) != (R * C, ow)
            or row_w.dtype != torch.float32 or col_w.dtype != torch.float32):
        raise ValueError("ramps must be (T, oh) and (T, ow) float32")
    if out.dtype != torch.uint8 or out.dim() != 3 or out.shape[2] != 3:
        raise ValueError("out must be (H, W, 3) uint8")
    if out_h < 1 or out_w < 1 or max(oh * ow * 3, R * C * max(oh, ow),
                                     out_w * 3) >= 2 ** 31:
        raise ValueError("kernel C indexes a tile, the ramps and a row of "
                         "the frame in 32 bits")
    lib = build.load_library()
    code = lib.w2x_finalize_gather(
        tile_ptrs.data_ptr(), row_w.data_ptr(), col_w.data_ptr(),
        out.data_ptr(), out_h, out_w, R, C, sy, sx, oh, ow, int(is_bf16),
        build.stream_handle(out.device))
    build.check(code, "finalize gather kernel")
    finalize_gather.launches += 1
    return out


finalize_gather.launches = 0


def make_finalize_epilogue(plan, device):
    """``finalize(*outs) -> (H, W, 3) u8`` for one geometry: kernel C for
    CUDA tensors, the plain scan for CPU tensors. Raises
    NotImplementedError for a CUDA device and a plan the kernel does not
    take."""
    device = torch.device(device)
    oh, ow = plan.output_tile
    out_h, out_w = plan.output_size
    T = plan.tile_count
    if device.type == "cpu":
        return lambda *outs: finalize_scan(outs, plan)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not epilogue_applicable(plan):
        raise NotImplementedError(
            "finalize: this tile plan is not a uniform grid with overlap <= "
            "stride; the gather kernel does not take it")
    R, C, sy, sx = grid_geometry(plan)
    geom = (R, C, sy, sx, oh, ow)
    row_w = torch.from_numpy(np.ascontiguousarray(plan.row_weights)).to(device)
    col_w = torch.from_numpy(np.ascontiguousarray(plan.col_weights)).to(device)
    tile_elems = oh * ow * 3

    def finalize(*outs):
        dt = outs[0].dtype
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"tile dtype {dt}: float32 or bfloat16 only")
        ptrs = []
        for c in outs:
            if (c.device != device or c.dtype != dt or not c.is_contiguous()
                    or tuple(c.shape[1:]) != (oh, ow, 3)):
                raise ValueError(
                    f"finalize pieces must be contiguous ({oh}, {ow}, 3) "
                    f"{dt} tensors on {device}")
            base = c.data_ptr()
            step = tile_elems * c.element_size()
            ptrs.extend(base + i * step for i in range(int(c.shape[0])))
        if len(ptrs) < T:
            raise ValueError(f"finalize got {len(ptrs)} tiles, plan has {T}")
        # pinned host memory and an asynchronous copy: no synchronize (the
        # caching host allocator keeps the block until the copy has run)
        table = torch.tensor(ptrs[:T], dtype=torch.int64,
                             pin_memory=True).to(device, non_blocking=True)
        out = torch.empty((out_h, out_w, 3), dtype=torch.uint8, device=device)
        return finalize_gather(table, row_w, col_w, out, geom,
                               dt == torch.bfloat16)

    return finalize
