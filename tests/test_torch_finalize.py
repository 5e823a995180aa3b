"""Kernel C's plain twin (the port's scan finalize) against the JAX
package's scan ``finalize`` (``make_chunked_fns``) and the Pallas gather
epilogue ``make_finalize_epilogue`` in interpret mode: byte-identical u8,
over the geometries of tests/test_finalize_epilogue.py, whole chunks and
TileStream-style piece splits.

The CUDA kernel runs only on the card; ``_gather_emulation`` replays its
thread mapping in numpy (one thread per 16-byte window of an output row,
the row's covering tiles found once, the first byte's (x, ch) by one
division; windows with one covering set as 16 bytes, each byte's pixel a
select on that first channel; partial windows at misaligned row ends and
windows across a tile edge byte by byte, (x, ch) stepped; ascending tile
order, each op rounded to fp32), so its index logic is checked here too,
over the cases
above and ``MORE_CASES``: a scale-4 grid, row bytes that are not a
multiple of 16, a single tile, a 1-row and a 1-column grid, each also
with a frame base that is not 16-byte aligned. On those the JAX scan is
held to the port byte for byte except where XLA:CPU fuses a multiply and
an add into an FMA and the sum rounds the other way (seen once in 302,400
bytes at scale 4); each such byte is checked to be exactly that.

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

# (frame_hw, tile, batch, dtype, scale)
MORE_CASES = [
    ((70, 90), 64, 4, "bfloat16", 4),   # scale 4: 2 x 2 tiles of 256
    ((61, 131), 64, 3, np.float32, 2),  # rows of 786 bytes (not 16k)
    ((37, 53), 64, 2, "bfloat16", 2),   # a single tile, rows of 318 bytes
    ((40, 200), 64, 3, np.float32, 2),  # 1-row grid
    ((200, 40), 64, 3, "bfloat16", 2),  # 1-column grid
]


def _setup(frame_hw, tile, batch, dtype, seed=0, scale=2):
    jcfg = JRenderConfig(precision=JPrecision.TF32, batch_size=batch,
                         height=tile, width=tile, scaling=scale,
                         overlap=(1 / 16, 1 / 16))
    cfg = RenderConfig(precision=Precision.TF32, batch_size=batch,
                       height=tile, width=tile, scaling=scale,
                       overlap=(1 / 16, 1 / 16))
    _p, jfin, jplan, jsizes = jax_chunked_fns(
        jax_get_spec("swin_unet/art", scale), jcfg, frame_hw, 1)
    _p, fin, plan, sizes = make_chunked_fns(
        get_spec("swin_unet/art", scale), cfg, frame_hw, "cpu")
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


def _cover(p, stride, n, size):
    """The kernel's ``cover``: the tiles lo..hi covering coordinate p along
    one axis (elementwise over an array p); hi < lo when none does."""
    hi = np.minimum(p // stride, n - 1)
    lo = np.where((hi > 0) & (p < (hi - 1) * stride + size), hi - 1, hi)
    return np.where(p - hi * stride >= size, hi + 1, lo), hi


def _blend(tiles, plan, y, rc, x, ch, cc):
    """The kernel's per-byte sum for bytes (y, x[i], ch[i]) with covering
    rows rc (the row's) and columns cc[i]: ascending t = c * R + r, every
    op rounded to fp32, then clip(rint(acc * 255)) -> u8."""
    R, _C, sy, sx = grid_geometry(plan)
    oh, ow = plan.output_tile
    rw = plan.row_weights.astype(np.float32)
    cw = plan.col_weights.astype(np.float32)
    acc = np.zeros(x.shape, np.float32)
    for dc in (0, 1):
        c = cc[0] + dc
        for r in range(rc[0], rc[1] + 1):
            live = c <= cc[1]
            t = np.where(live, c * R + r, 0)
            ly = y - r * sy
            lx = np.where(live, x - c * sx, 0)
            v = tiles[t, ly, lx, ch]
            contrib = (v * rw[t, ly]) * cw[t, lx]
            acc = np.where(live, acc + contrib, acc)
    return np.clip(np.rint(acc * np.float32(255.0)), 0, 255).astype(np.uint8)


def _gather_emulation(plan, tiles, misalign=0):
    """numpy replay of csrc/finalize_epilogue.cu's thread mapping on
    (T, oh, ow, 3) fp32 tile values (float(v) of the compute dtype), for a
    frame whose base address is ``misalign`` mod 16. Every byte must be
    written by exactly one thread."""
    R, C, sy, sx = grid_geometry(plan)
    oh, ow = plan.output_tile
    out_h, out_w = plan.output_size
    row_bytes = out_w * 3
    out = np.zeros((out_h, row_bytes), np.uint8)
    writes = np.zeros((out_h, row_bytes), np.int32)
    i16 = np.arange(16)
    for y in range(out_h):  # blockIdx.y: the row's covering tiles, once
        rc = tuple(int(v) for v in _cover(np.array(y), sy, R, oh))
        m = (misalign + y * row_bytes) % 16
        s = 16 * np.arange(-(-(m + row_bytes) // 16)) - m  # thread k's window
        full = (s >= 0) & (s + 16 <= row_bytes)
        x0 = np.where(full, s, 0) // 3  # one division by 3
        ch0 = np.where(full, s, 0) - 3 * x0
        ca = _cover(x0, sx, C, ow)
        cb = _cover(x0 + 5, sx, C, ow)
        one = full & (ca[0] == cb[0]) & (ca[1] == cb[1])
        # 16-byte windows: byte i is pixel i // 3 + (ch0 + i % 3 >= 3)
        w = np.flatnonzero(one)
        x = x0[w, None] + i16 // 3 + (ch0[w, None] + i16 % 3 >= 3)
        ch = (ch0[w, None] + i16) % 3
        cc = (np.broadcast_to(ca[0][w, None], x.shape),
              np.broadcast_to(ca[1][w, None], x.shape))
        cols = s[w, None] + i16
        out[y, cols] = _blend(tiles, plan, y, rc, x, ch, cc)
        np.add.at(writes[y], cols.ravel(), 1)
        # the rest byte by byte, (x, ch) stepped, the columns per pixel
        xs, chs, cols = [], [], []
        for k in np.flatnonzero(~one):
            lo, hi = max(int(s[k]), 0), min(int(s[k]) + 16, row_bytes)
            px, c = divmod(lo, 3)
            for i in range(lo, hi):
                xs.append(px)
                chs.append(c)
                cols.append(i)
                c += 1
                if c == 3:
                    c, px = 0, px + 1
        if cols:
            x = np.array(xs)
            cc = _cover(x, sx, C, ow)
            out[y, cols] = _blend(tiles, plan, y, rc, x, np.array(chs), cc)
            np.add.at(writes[y], cols, 1)
    assert (writes == 1).all(), "a byte written by no thread or by two"
    return out.reshape(out_h, out_w, 3)


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


def _assert_equal_but_xla_cpu_fma(got, want, plan, tiles):
    """``got`` (every op rounded on its own) equals ``want`` (the JAX scan
    on XLA:CPU) byte for byte, except where XLA:CPU contracts a tile's
    last multiply and the add onto the canvas into one FMA and the sum
    rounds the other way: at each such byte the FMA form must give
    ``want``'s byte and the unfused form ``got``'s."""
    oh, ow = plan.output_tile
    for y, x, ch in np.argwhere(got != want):
        fused = plain = np.float32(0)
        for t, (oy, ox) in enumerate(plan.output_origins):
            if not (oy <= y < oy + oh and ox <= x < ox + ow):
                continue
            a = np.float32(tiles[t, y - oy, x - ox, ch]
                           * plan.row_weights[t, y - oy])
            cw = plan.col_weights[t, x - ox]
            plain = np.float32(plain + np.float32(a * cw))
            # float64 holds the f32 x f32 product exactly
            fused = np.float32(np.float64(a) * np.float64(cw)
                               + np.float64(fused))
        q = [np.clip(np.rint(v * np.float32(255.0)), 0, 255)
             for v in (fused, plain)]
        assert (q[0], q[1]) == (want[y, x, ch], got[y, x, ch]), (y, x, ch)


@pytest.mark.parametrize("frame_hw,tile,batch,dtype,scale", MORE_CASES)
def test_plain_matches_jax_scan_more_geometries(frame_hw, tile, batch, dtype,
                                                scale):
    jfin, _jp, jouts, fin, plan, touts = _setup(frame_hw, tile, batch, dtype,
                                                seed=3, scale=scale)
    assert epilogue_applicable(plan)
    tiles = torch.cat(touts, 0)[:plan.tile_count].float().numpy()
    _assert_equal_but_xla_cpu_fma(fin(*touts).numpy(), np.array(jfin(*jouts)),
                                  plan, tiles)


@pytest.mark.parametrize("misalign", [0, 5])
@pytest.mark.parametrize("frame_hw,tile,batch,dtype,scale", MORE_CASES)
def test_gather_emulation_more_geometries(frame_hw, tile, batch, dtype,
                                          scale, misalign):
    jfin, _jp, jouts, fin, plan, touts = _setup(frame_hw, tile, batch, dtype,
                                                seed=3, scale=scale)
    tiles = torch.cat(touts, 0)[:plan.tile_count].float().numpy()
    got = _gather_emulation(plan, tiles, misalign)
    np.testing.assert_array_equal(got, fin(*touts).numpy())
    _assert_equal_but_xla_cpu_fma(got, np.array(jfin(*jouts)), plan, tiles)


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
