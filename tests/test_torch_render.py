"""Whole renders of the PyTorch port on the CPU against the JAX package.

- ``Upscaler(device="cpu")`` against the JAX ``ChunkedPipeline``, same
  seed-0 weights (one ``.npz`` read by both), fp32, odd 75x101 frame,
  tile 64, batch 2, through the golden gate (max <= 2 LSB, <= 1e-4 of
  pixels changed);
- the identity-model drive (nearest-neighbour "model"): byte-identical to
  the upsampled input, per frame and streamed;
- TileStream output equals per-frame output;
- every row of ``tests/test_golden.py::CONFIGS`` (swin tiles, whole
  frame, 8-way TTA, tile 400; cunet tiles and whole frame), rendered by
  the port with the JAX seed-0 ``init_params`` bridged across, against
  the stored golden under the row's own gate;
- the port's CLI ``render`` of a PNG on ``--device cpu`` gives the bytes
  of the library render, also with ``--tta``, ``--tileSize 0``,
  ``--bucket`` and ``cunet/art``, under the JAX CLI's output names; the
  options still to port exit "not yet ported".
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.engine.config import Precision as JPrecision
from waifu2x_tensorrt_tpu.engine.config import RenderConfig as JRenderConfig
from waifu2x_tensorrt_tpu.engine.renderer import (
    ChunkedPipeline as JChunkedPipeline,
)
from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import ChunkedPipeline
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.models import registry as treg
from test_golden import CONFIGS as GOLDEN_CONFIGS
from test_golden import _name as golden_name

GOLDEN = Path(__file__).parent / "golden" / "swin_unet_art_s2_n-1.png"


def _gate(got, ref, max_tol=2, frac_tol=1e-4):
    diff = np.abs(got.astype(int) - ref.astype(int))
    frac = float((diff > 0).mean())
    return diff.max() <= max_tol and frac <= frac_tol, (diff.max(), frac)


def _cfg(tile=64, batch=2, scale=2):
    return RenderConfig(precision=Precision.TF32, batch_size=batch,
                        height=tile, width=tile, scaling=scale,
                        overlap=(1 / 16, 1 / 16))


def _pattern(h, w, k=0):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 5 + k * 11) % 256, yy * 7 % 256,
                     (xx + yy + k) * 3 % 256], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def seed0_models(tmp_path_factory):
    """JAX module, seed-0 flax params, and a models dir holding them."""
    module, _ = jreg.create_model("swin_unet/art", 2, -1)
    params = jreg.init_params(module, tile=64, seed=0)
    root = tmp_path_factory.mktemp("models")
    jreg.save_params(jreg.weights_path(root, "swin_unet/art", 2, -1), params)
    return module, params, root


def test_upscaler_matches_jax_pipeline(seed0_models):
    module, params, root = seed0_models
    frame = np.random.default_rng(0).integers(0, 256, (75, 101, 3), np.uint8)
    spec = jreg.get_spec("swin_unet/art", 2, -1)
    jcfg = JRenderConfig(precision=JPrecision.TF32, batch_size=2, height=64,
                         width=64, scaling=2, overlap=(1 / 16, 1 / 16))
    want = np.asarray(JChunkedPipeline(module, spec, jcfg).render(
        params, jnp.array(frame)))
    up = Upscaler(models_dir=root, device="cpu")
    up.load("swin_unet/art", 2, -1, _cfg())
    got = up.render(frame)
    assert got.shape == want.shape == (150, 202, 3) and got.dtype == np.uint8
    ok, msg = _gate(got, want)
    assert ok, msg
    # the other block configuration renders through the gate as well
    up.load("swin_unet/art", 2, -1, _cfg(), fused_block=True)
    ok, msg = _gate(up.render(frame), want)
    assert ok, msg


def test_stream_equals_per_frame(seed0_models):
    _m, _p, root = seed0_models
    up = Upscaler(models_dir=root, device="cpu")
    up.load("swin_unet/art", 2, -1, _cfg(batch=3))
    frames = [_pattern(64, 96, k) for k in range(3)]
    per_frame = [up.render(f) for f in frames]
    stream = up.open_stream((64, 96))
    got = []
    for f in frames:
        got.extend(o.numpy() for o in stream.submit(f))
    got.extend(o.numpy() for o in stream.flush())
    assert len(got) == 3
    for g, w in zip(got, per_frame):
        ok, msg = _gate(g, w)
        assert ok, msg


class NearestUp(torch.nn.Module):
    """Identity model: nearest-neighbour upsample of NHWC tiles."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        s = self.scale
        return x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)


@pytest.mark.parametrize("hw,tile,batch,scale,blend", [
    ((223, 317), 64, 4, 2, 1 / 16),
    ((100, 160), 64, 3, 2, 0.0),
    ((70, 50), 64, 2, 4, 1 / 8),
    ((1, 1), 64, 1, 2, 1 / 16),
])
def test_identity_model_byte_exact(hw, tile, batch, scale, blend):
    spec = treg.get_spec("swin_unet/art", scale, -1)
    cfg = RenderConfig(precision=Precision.TF32, batch_size=batch,
                       height=tile, width=tile, scaling=scale,
                       overlap=(blend, blend))
    pl = ChunkedPipeline(NearestUp(scale), spec, cfg, "cpu")
    frame = np.random.default_rng(1).integers(0, 256, (*hw, 3), np.uint8)
    want = np.repeat(np.repeat(frame, scale, 0), scale, 1)
    np.testing.assert_array_equal(pl.render(frame).numpy(), want)
    from waifu2x_tensorrt_tpu_torch.engine.renderer import TileStream

    stream = TileStream(pl, hw)
    outs = []
    for _ in range(3):
        outs.extend(stream.submit(frame))
    outs.extend(stream.flush())
    assert len(outs) == 3
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), want)


@pytest.fixture(scope="module")
def golden_params(seed0_models):
    """``get(family, scale, noise)``: the seed-0 flax params of a golden
    row's model, as tests/test_golden.py makes them (``init_params``, tile
    64); the init runs as one jitted program, which draws the same values
    as the eager one in a third of the time."""
    cache = {("swin_unet/art", 2, -1): seed0_models[1]}

    def get(family, scale, noise):
        key = (family, scale, noise)
        if key not in cache:
            module, _ = jreg.create_model(family, scale, noise)
            cache[key] = jax.jit(module.init)(
                jax.random.PRNGKey(0),
                jnp.zeros((1, 64, 64, 3), jnp.float32))["params"]
        return cache[key]

    return get


@pytest.mark.parametrize("family,scale,noise,tile,h,w,tol,frac,tta",
                         GOLDEN_CONFIGS,
                         ids=[golden_name(*c[:4], c[8])[:-4]
                              for c in GOLDEN_CONFIGS])
def test_full_width_golden_through_port(golden_params, family, scale, noise,
                                        tile, h, w, tol, frac, tta):
    """Every row of tests/test_golden.py (full width, tf32, batch 2: tiles,
    whole frame, 8-way TTA, cunet, tile 400), rendered by the port with the
    JAX seed-0 flax init bridged across, against the stored golden under
    the row's own gate."""
    from waifu2x_tensorrt_tpu.io.image import read_image

    path = GOLDEN.parent / golden_name(family, scale, noise, tile, tta)
    if not path.exists():
        pytest.skip("golden not generated")
    tmod, spec = treg.create_model(family, scale, noise)
    treg.load_into(tmod, jreg._flatten(golden_params(family, scale, noise)))
    cfg = RenderConfig(precision=Precision.TF32, batch_size=2, height=tile,
                       width=tile, scaling=scale, overlap=(1 / 16, 1 / 16),
                       tta=tta)
    got = ChunkedPipeline(tmod, spec, cfg, "cpu").render(
        _pattern(h, w)).numpy()
    ref = read_image(path)
    assert got.shape == ref.shape
    ok, msg = _gate(got, ref, tol, frac)
    assert ok, msg


def test_cli_render_matches_library(tmp_path):
    from waifu2x_tensorrt_tpu_torch import cli
    from waifu2x_tensorrt_tpu_torch.io.image import read_image, write_image

    src = tmp_path / "in.png"
    frame = _pattern(37, 45)
    write_image(src, frame)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    rc = cli.main(["--model", "swin_unet/art", "--scale", "2", "--noise",
                   "-1", "--batchSize", "2", "--tileSize", "64",
                   "--precision", "tf32", "--device", "cpu",
                   "--models-dir", str(tmp_path / "none"),
                   "--allow-random-weights", "render", "-i", str(src),
                   "-o", str(out_dir)])
    assert rc == 0
    written = read_image(out_dir / "in(swin_unet_art)(scale2).png")
    up = Upscaler(models_dir=tmp_path / "none", allow_random_init=True,
                  device="cpu")
    up.load("swin_unet/art", 2, -1, _cfg())
    np.testing.assert_array_equal(written, up.render(frame))


@pytest.mark.parametrize("flags,render_flags", [
    ({"--model": "cunet/art", "--noise": "1"}, ["--tta"]),
    ({"--tileSize": "0"}, []),
    ({}, ["--bucket", "16"]),
    ({"--model": "cunet/art", "--noise": "1"}, []),
    ({"--model": "cunet/art", "--scale": "1", "--noise": "0",
      "--tileSize": "0"}, ["--tta"]),
], ids=["tta", "tile0", "bucket", "cunet", "cunet1x-tile0-tta"])
def test_cli_renders_tta_whole_frame_bucket_cunet(tmp_path, flags,
                                                  render_flags):
    """The CLI renders what ``Upscaler.render`` renders at the same
    settings, under the JAX CLI's output name (``(tta)`` included)."""
    from waifu2x_tensorrt_tpu.cli import output_suffix as jax_suffix
    from waifu2x_tensorrt_tpu_torch import cli
    from waifu2x_tensorrt_tpu_torch.io.image import read_image, write_image

    src = tmp_path / "in.png"
    frame = _pattern(29, 35)
    write_image(src, frame)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    opts = {"--model": "swin_unet/art", "--scale": "2", "--noise": "-1",
            "--batchSize": "3", "--tileSize": "64", **flags}
    rc = cli.main([x for kv in opts.items() for x in kv]
                  + ["--precision", "tf32", "--device", "cpu",
                     "--models-dir", str(tmp_path / "none"),
                     "--allow-random-weights", "render", "-i", str(src),
                     "-o", str(out_dir), *render_flags])
    assert rc == 0
    family, tile = opts["--model"], int(opts["--tileSize"])
    scale, noise = int(opts["--scale"]), int(opts["--noise"])
    tta = "--tta" in render_flags
    bucket = int(render_flags[1]) if "--bucket" in render_flags else 0
    name = f"in{jax_suffix(family, noise, scale, tta)}.png"
    assert [p.name for p in out_dir.iterdir()] == [name]
    up = Upscaler(models_dir=tmp_path / "none", allow_random_init=True,
                  device="cpu")
    up.load(family, scale, noise,
            RenderConfig(precision=Precision.TF32, batch_size=3, height=tile,
                         width=tile, scaling=scale,
                         overlap=(1 / 16, 1 / 16), tta=tta), bucket=bucket)
    np.testing.assert_array_equal(read_image(out_dir / name),
                                  up.render(frame))


def test_cli_tf32_precision_is_fp32(tmp_path):
    """--precision tf32 turns torch's TF32 paths off for the process, so
    cuDNN's convolutions on the card run in fp32."""
    from waifu2x_tensorrt_tpu_torch import cli
    from waifu2x_tensorrt_tpu_torch.io.image import write_image

    write_image(tmp_path / "in.png", _pattern(8, 8))
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        argv = ["--model", "swin_unet/art", "--scale", "2", "--noise", "-1",
                "--batchSize", "1", "--tileSize", "64", "--device", "cpu",
                "--models-dir", str(tmp_path / "none"),
                "--allow-random-weights", "render", "-i",
                str(tmp_path / "in.png"), "-o", str(tmp_path)]
        assert cli.main(["--precision", "fp16", *argv]) == 0
        assert torch.backends.cudnn.allow_tf32
        assert cli.main(["--precision", "tf32", *argv]) == 0
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.parametrize("argv", [
    ["--tileSize", "auto"], ["--dp", "2"],
])
def test_cli_unported_options_exit_nonzero(tmp_path, argv, capsys):
    from waifu2x_tensorrt_tpu_torch import cli

    base = {"--model": "swin_unet/art", "--tileSize": "64"}
    for i in range(0, len(argv) - 1, 2):
        base[argv[i]] = argv[i + 1]
    args = ["--scale", "2", "--noise", "1", "--batchSize", "2",
            "--device", "cpu"]
    for k, v in base.items():
        args += [k, v]
    args += ["render", "-i", str(tmp_path)]
    assert cli.main(args) != 0
    assert "not yet ported" in capsys.readouterr().err


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    up = Upscaler(allow_random_init=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        up.load("swin_unet/art", 2, -1, _cfg())


def test_small_checkpoint_loads_and_renders(tmp_path):
    """A swin .npz of another width and depth than the flagship's: the
    port builds its module from the file and renders what the JAX package
    renders from the same weights, through the golden gate."""
    arch = {"base_dim": 32, "depths": (1, 1, 2, 1, 1)}
    module, _ = jreg.create_model("swin_unet/art", 2, -1, **arch)
    params = jreg.init_params(module, tile=64, seed=2)
    jreg.save_params(jreg.weights_path(tmp_path, "swin_unet/art", 2, -1),
                     params)
    frame = np.random.default_rng(1).integers(0, 256, (53, 70, 3), np.uint8)
    spec = jreg.get_spec("swin_unet/art", 2, -1)
    jcfg = JRenderConfig(precision=JPrecision.TF32, batch_size=2, height=64,
                         width=64, scaling=2, overlap=(1 / 16, 1 / 16))
    want = np.asarray(JChunkedPipeline(module, spec, jcfg).render(
        params, jnp.array(frame)))
    up = Upscaler(models_dir=tmp_path, device="cpu")
    up.load("swin_unet/art", 2, -1, _cfg())
    assert treg.checkpoint_arch(
        treg.weights_path(tmp_path, "swin_unet/art", 2, -1)) == arch
    got = up.render(frame)
    assert got.shape == want.shape == (106, 140, 3)
    ok, msg = _gate(got, want)
    assert ok, msg
