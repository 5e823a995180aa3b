"""Kernel C's plain twin (the port's scan finalize) against the JAX
package's scan ``finalize`` (``make_chunked_fns``) and the Pallas gather
epilogue ``make_finalize_epilogue`` in interpret mode: byte-identical u8,
over the geometries of tests/test_finalize_epilogue.py, whole chunks and
TileStream-style piece splits.

The CUDA kernel runs only on the card; ``_gather_emulation`` replays its
per-element algorithm (covering-tile selection, ascending tile order, each
op rounded to fp32) in numpy, so its index logic is checked here too.

Each framework gets its own copy of every array (``jnp.array``,
``torch.tensor``, ``np.array``): on the CPU ``jnp.asarray`` and
``np.asarray`` share memory with their argument, and a comparison must
not depend on what the other side does to that memory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.engine.config import Precision as JPrecision
from waifu2x_tensorrt_tpu.engine.config import RenderConfig as JRenderConfig
from waifu2x_tensorrt_tpu.engine.renderer import (
    make_chunked_fns as jax_chunked_fns,
)
from waifu2x_tensorrt_tpu.models.registry import get_spec as jax_get_spec
from waifu2x_tensorrt_tpu.ops.finalize_epilogue import (
    make_finalize_epilogue as jax_epilogue,
)
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import make_chunked_fns
from waifu2x_tensorrt_tpu_torch.models.registry import get_spec
from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
    epilogue_applicable,
    grid_geometry,
    make_finalize_epilogue,
)

CASES = [
    ((100, 110), 64, 3, np.float32),
    ((100, 110), 64, 4, "bfloat16"),
    ((150, 260), 64, 5, np.float32),
    ((40, 110), 64, 3, np.float32),   # single tile row
    ((75, 101), 64, 2, "bfloat16"),
]


def _setup(frame_hw, tile, batch, dtype, seed=0):
    jcfg = JRenderConfig(precision=JPrecision.TF32, batch_size=batch,
                         height=tile, width=tile, scaling=2,
                         overlap=(1 / 16, 1 / 16))
    cfg = RenderConfig(precision=Precision.TF32, batch_size=batch,
                       height=tile, width=tile, scaling=2,
                       overlap=(1 / 16, 1 / 16))
    _p, jfin, jplan, jsizes = jax_chunked_fns(
        jax_get_spec("swin_unet/art", 2), jcfg, frame_hw, 1)
    _p, fin, plan, sizes = make_chunked_fns(
        get_spec("swin_unet/art", 2), cfg, frame_hw, "cpu")
    assert sizes == jsizes
    oh, ow = plan.output_tile
    rng = np.random.default_rng(seed)
    raw = [rng.random((n, oh, ow, 3), np.float32) for n in sizes]
    if dtype == "bfloat16":
        jouts = [jnp.array(r).astype(jnp.bfloat16) for r in raw]
        touts = [torch.tensor(r).bfloat16() for r in raw]
    else:
        jouts = [jnp.array(r) for r in raw]
        touts = [torch.tensor(r) for r in raw]
    return jfin, jplan, jouts, fin, plan, touts


def _gather_emulation(plan, tiles):
    """numpy replay of csrc/finalize_epilogue.cu on (T, oh, ow, 3) fp32
    tile values (already in fp32, i.e. float(v) of the compute dtype)."""
    R, C, sy, sx = grid_geometry(plan)
    oh, ow = plan.output_tile
    out_h, out_w = plan.output_size
    y = np.arange(out_h)[:, None]
    x = np.arange(out_w)[None, :]
    r1 = np.minimum(y // sy, R - 1)
    c1 = np.minimum(x // sx, C - 1)
    r0 = np.where((r1 > 0) & (y < (r1 - 1) * sy + oh), r1 - 1, r1)
    c0 = np.where((c1 > 0) & (x < (c1 - 1) * sx + ow), c1 - 1, c1)
    rw = plan.row_weights.astype(np.float32)
    cw = plan.col_weights.astype(np.float32)
    acc = np.zeros((out_h, out_w, 3), np.float32)
    for dc in (0, 1):
        for dr in (0, 1):  # ascending t = c * R + r
            c = np.broadcast_to(c0 + dc, (out_h, out_w))
            r = np.broadcast_to(r0 + dr, (out_h, out_w))
            live = (c <= c1) & (r <= r1)
            ly = np.clip(y - r * sy, 0, oh - 1)
            lx = np.clip(x - c * sx, 0, ow - 1)
            t = np.clip(c * R + r, 0, plan.tile_count - 1)
            v = tiles[t, ly, lx]                       # (H, W, 3)
            contrib = (v * rw[t, ly][..., None]) * cw[t, lx][..., None]
            acc = np.where(live[..., None], acc + contrib, acc)
    q = np.clip(np.rint(acc * np.float32(255.0)), 0, 255)
    return q.astype(np.uint8)


@pytest.mark.parametrize("frame_hw,tile,batch,dtype", CASES)
def test_plain_matches_jax_scan_and_epilogue(frame_hw, tile, batch, dtype):
    jfin, jplan, jouts, fin, plan, touts = _setup(frame_hw, tile, batch,
                                                  dtype)
    want = np.array(jfin(*jouts))
    got = fin(*touts).numpy()
    assert got.dtype == np.uint8 and got.shape == (*plan.output_size, 3)
    np.testing.assert_array_equal(got, want)
    g = grid_geometry(plan)
    assert g is not None and epilogue_applicable(plan)
    if g[0] >= 2 and g[1] >= 2:  # the Pallas epilogue needs a 2x2 grid
        epi = np.array(jax_epilogue(jplan, interpret=True)(*jouts))
        np.testing.assert_array_equal(got, epi)


@pytest.mark.parametrize("frame_hw,tile,batch,dtype", CASES)
def test_gather_emulation_byte_identical(frame_hw, tile, batch, dtype):
    _jf, _jp, _jo, fin, plan, touts = _setup(frame_hw, tile, batch, dtype,
                                             seed=2)
    tiles = torch.cat(touts, 0)[:plan.tile_count].float().numpy()
    np.testing.assert_array_equal(_gather_emulation(plan, tiles),
                                  fin(*touts).numpy())


@pytest.mark.parametrize("split", [[1, 5], [4, 1, 1], [2, 2, 2]])
def test_tile_stream_piece_splits(split):
    """TileStream hands finalize pieces cut at arbitrary chunk boundaries,
    including views into larger model outputs."""
    jfin, _jp, jouts, fin, plan, touts = _setup((100, 110), 64, 6,
                                                np.float32, seed=5)
    want = np.array(jfin(*jouts))
    whole = torch.cat(touts, 0)
    padded = torch.cat([torch.zeros_like(whole[:3]), whole,
                        torch.zeros_like(whole[:2])], 0)
    pieces, start = [], 3
    for n in split:
        pieces.append(padded[start:start + n])
        start += n
    np.testing.assert_array_equal(fin(*pieces).numpy(), want)
    jpieces, start = [], 0
    for n in split:
        jpieces.append(jnp.array(whole[start:start + n].numpy()))
        start += n
    np.testing.assert_array_equal(np.array(jfin(*jpieces)), want)


def test_cuda_plan_check_is_geometric():
    cfg = RenderConfig(precision=Precision.FP16, batch_size=16, height=256,
                       width=256, scaling=4, overlap=(1 / 16, 1 / 16))
    from waifu2x_tensorrt_tpu_torch.engine.renderer import resolve_tile_plan

    plan = resolve_tile_plan(get_spec("swin_unet/art", 4, 3), cfg, (720, 1280))
    assert grid_geometry(plan) == (3, 6, 960, 960)
    assert epilogue_applicable(plan)
    # a plan whose origins are not a uniform grid is refused on CUDA
    bad = type(plan)(**{**plan.__dict__, "output_origins":
                        plan.output_origins[::-1].copy()})
    assert not epilogue_applicable(bad)
    with pytest.raises(NotImplementedError):
        make_finalize_epilogue(bad, "cuda:0")
