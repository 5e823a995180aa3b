"""Whole renders of the PyTorch port on the CPU against the JAX package.

- ``Upscaler(device="cpu")`` against the JAX ``ChunkedPipeline``, same
  seed-0 weights (one ``.npz`` read by both), fp32, odd 75x101 frame,
  tile 64, batch 2, through the golden gate (max <= 2 LSB, <= 1e-4 of
  pixels changed);
- the identity-model drive (nearest-neighbour "model"): byte-identical to
  the upsampled input, per frame and streamed;
- TileStream output equals per-frame output;
- the stored full-width ``swin_unet_art_s2_n-1.png`` golden, rendered by
  the port with the JAX seed-0 ``init_params`` bridged across;
- the port's CLI ``render`` of a PNG on ``--device cpu`` gives the bytes
  of the library render.
"""

from pathlib import Path

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


def test_full_width_golden_through_port():
    """tests/test_golden.py's swin row (40x56, tile 64, batch 2, tf32),
    rendered by the port with the JAX seed-0 flax init bridged across."""
    from waifu2x_tensorrt_tpu.io.image import read_image

    if not GOLDEN.exists():
        pytest.skip("golden not generated")
    module, _ = jreg.create_model("swin_unet/art", 2, -1)
    params = jreg.init_params(module, tile=64, seed=0)
    tmod, spec = treg.create_model("swin_unet/art", 2, -1)
    treg.load_into(tmod, jreg._flatten(params))
    got = ChunkedPipeline(tmod, spec, _cfg(), "cpu").render(
        _pattern(40, 56)).numpy()
    ref = read_image(GOLDEN)
    assert got.shape == ref.shape
    ok, msg = _gate(got, ref)
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


@pytest.mark.parametrize("extra", [
    ["--tta"], ["--alpha", "auto"],
])
def test_cli_unported_flags_exit_nonzero(tmp_path, extra, capsys):
    from waifu2x_tensorrt_tpu_torch import cli

    argv = ["--model", "swin_unet/art", "--scale", "2", "--noise", "-1",
            "--batchSize", "2", "--tileSize", "64", "--device", "cpu",
            "render", "-i", str(tmp_path)] + extra
    assert cli.main(argv) != 0
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--tileSize", "0"], ["--tileSize", "auto"], ["--dp", "2"],
    ["--model", "cunet/art"], ["build"],
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
    args += ["build"] if argv == ["build"] else ["render", "-i",
                                                 str(tmp_path)]
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
