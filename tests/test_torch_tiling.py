"""The port's tile planner equals the JAX package's, exactly, over the
geometries of tests/test_tiling.py (and the flagship 720p -> 4x plan),
and so does its whole-frame plan; its dihedral TTA transforms equal the
JAX package's on numpy for all 8 indices, square and rectangular, and
round-trip exactly on torch tensors."""

import dataclasses

import numpy as np
import pytest

from waifu2x_tensorrt_tpu import tiling as jax_tiling
from waifu2x_tensorrt_tpu_torch import tiling as torch_tiling

CASES = [
    ((200, 300), 64, 128, 2, 0.0625),
    ((200, 300), 64, 128, 2, 0.125),
    ((128, 128), 64, 128, 2, 0.0),
    ((100, 160), 64, 256, 4, 0.0625),
    ((140, 90), 64, 112, 2, 0.0625),
    ((97, 61), 64, 112, 2, 0.03125),
    ((256, 256), 256, 440, 2, 0.0625),
    ((16, 11), 64, 128, 2, 0.0625),
    ((1, 1), 64, 128, 2, 0.0625),
    ((3, 70), 64, 128, 2, 0.0625),
    ((720, 1280), 256, 1024, 4, 0.0625),  # the flagship geometry
]


def _assert_plans_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("hw,in_tile,out_tile,scale,overlap", CASES)
def test_plan_equals_jax(hw, in_tile, out_tile, scale, overlap):
    args = (hw, (in_tile, in_tile), (out_tile, out_tile), scale,
            (overlap, overlap))
    _assert_plans_equal(torch_tiling.plan_tiles(*args),
                        jax_tiling.plan_tiles(*args))


def test_randomized_sweep_equals_jax():
    """The 40-geometry sweep of test_tiling's randomized reconstruction."""
    rng = np.random.default_rng(7)
    for _ in range(40):
        scale = int(rng.choice([1, 2, 4]))
        in_tile = int(rng.choice([32, 64, 96]))
        full = in_tile * scale
        if rng.random() < 0.3 and full > 4 * scale:
            k = int(rng.integers(1, min(8, full // (2 * scale))))
            out_tile = full - 2 * k * scale
        else:
            out_tile = full
        overlap = float(rng.choice([0.0, 1 / 32, 1 / 16, 1 / 8]))
        hw = (int(rng.integers(1, 220)), int(rng.integers(1, 220)))
        args = (hw, (in_tile, in_tile), (out_tile, out_tile), scale,
                (overlap, overlap))
        _assert_plans_equal(torch_tiling.plan_tiles(*args),
                            jax_tiling.plan_tiles(*args))


def test_calculate_tiles_and_ramps_equal_jax():
    args = ((300, 200), (600, 400), (64, 64), (128, 128), 2, (1 / 16, 1 / 16))
    n_t, in_t, out_t = torch_tiling.calculate_tiles(*args)
    n_j, in_j, out_j = jax_tiling.calculate_tiles(*args)
    assert n_t == n_j
    for rects_t, rects_j in ((in_t, in_j), (out_t, out_j)):
        assert [dataclasses.astuple(r) for r in rects_t] == \
            [dataclasses.astuple(r) for r in rects_j]
    for a, b in zip(torch_tiling.tile_weight_ramps((8, 4), (128, 96)),
                    jax_tiling.tile_weight_ramps((8, 4), (128, 96))):
        np.testing.assert_array_equal(a, b)


def test_too_small_tile_raises_named_error():
    with pytest.raises(ValueError, match="too small"):
        torch_tiling.calculate_tiles((200, 200), (200, 200), (60, 60),
                                     (4, 4), 1, (1 / 16, 1 / 16))


def test_dihedral_tables_equal_jax():
    assert torch_tiling.DIHEDRAL_SIZE == jax_tiling.DIHEDRAL_SIZE == 8
    assert (torch_tiling.DIHEDRAL_SHAPE_PRESERVING
            == jax_tiling.DIHEDRAL_SHAPE_PRESERVING)
    assert torch_tiling.DIHEDRAL_TRANSPOSING == jax_tiling.DIHEDRAL_TRANSPOSING
    assert torch_tiling._DIHEDRAL_FWD == jax_tiling._DIHEDRAL_FWD


@pytest.mark.parametrize("shape", [(5, 5, 3), (2, 5, 7, 3)],
                         ids=["square", "rect-batch"])
@pytest.mark.parametrize("index", range(8))
def test_dihedral_equals_jax_and_round_trips_on_torch(shape, index):
    import torch

    img = np.random.default_rng(index).integers(0, 256, shape).astype(
        np.float32)
    want = jax_tiling.dihedral_apply(img, index)
    got = torch_tiling.dihedral_apply(img, index)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(torch_tiling.dihedral_inverse(got, index),
                                  jax_tiling.dihedral_inverse(want, index))
    transposing = index in torch_tiling.DIHEDRAL_TRANSPOSING
    hw = shape[-3:-1]
    assert got.shape[-3:-1] == (hw[::-1] if transposing else hw)
    t = torch.from_numpy(img).to(torch.bfloat16)
    fwd = torch_tiling.dihedral_apply(t, index)
    np.testing.assert_array_equal(fwd.float().numpy(), want)
    back = torch_tiling.dihedral_inverse(fwd, index)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


@pytest.mark.parametrize("family,scale,hw", [
    ("cunet/art", 2, (48, 40)), ("cunet/art", 1, (37, 53)),
    ("cunet/art", 2, (512, 512)), ("swin_unet/art", 2, (40, 56)),
    ("swin_unet/art", 4, (33, 17)),
])
def test_whole_frame_plan_equals_jax(family, scale, hw):
    """--tileSize 0: one tile holding the model's context, rounded up to
    its tile divisor (cunet 2x on 512 x 512: a 548 x 548 tile)."""
    from waifu2x_tensorrt_tpu.engine.config import RenderConfig as JCfg
    from waifu2x_tensorrt_tpu.engine.renderer import (
        resolve_tile_plan as jresolve,
    )
    from waifu2x_tensorrt_tpu.models.registry import get_spec as jspec
    from waifu2x_tensorrt_tpu_torch.engine.config import RenderConfig
    from waifu2x_tensorrt_tpu_torch.engine.renderer import resolve_tile_plan
    from waifu2x_tensorrt_tpu_torch.models.registry import get_spec

    kw = dict(height=0, width=0, scaling=scale, overlap=(1 / 16, 1 / 16))
    got = resolve_tile_plan(get_spec(family, scale, 1), RenderConfig(**kw),
                            hw)
    _assert_plans_equal(got, jresolve(jspec(family, scale, 1), JCfg(**kw),
                                      hw))
    assert got.tile_count == 1
    if hw == (512, 512):
        assert got.input_tile == (548, 548)
        assert got.output_tile == (1024, 1024) == got.canvas_size
