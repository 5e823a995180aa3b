"""HAT (``models/hat.py``) and kernel G's plain twin
(``ops/hat_attention.py``) on the CPU, and hat/photo in the registry, the
Upscaler and the CLI.

The JAX package has no HAT, so the port is held to the benchmark's plain
float32 reference (``benchmark_torch/reference/hat.py``, written from the
published equations), on the benchmark's seeded weights, at a small size:
embed 60 (2 heads of 30), window 16, one group of 2 HABs and an OCAB,
48 x 48 tiles (9 windows, so one window touches no border).

Tolerances:
- fp32, atol 3e-5: the repository's full-model fp32 tolerance; the two
  differ only in the order of fp32 sums (about 1e-6 here), while the
  reference with every product's operands rounded to bf16 misses by
  about 1e-2 (checked below, so the tolerance can see a bf16 error);
- bf16: the repository's rule |port_bf16 - ref_fp32| <= max(2
  |ref_bf16 - ref_fp32|, 0.02), ref_bf16 the reference with every
  product's operands rounded to bf16;
- kernel G's twin against a direct softmax(q k^T d^-0.5 + bias + mask) v
  in float64 over explicit token coordinates, atol 1e-5: fp32 rounding of
  scores of magnitude ~10 and of 576-term sums.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark_torch.lib import weights
from benchmark_torch.reference import hat as ref
from benchmark_torch.reference.render import render as ref_render
from waifu2x_tensorrt_tpu_torch import cli
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.models import registry
from waifu2x_tensorrt_tpu_torch.models.convert import (
    hat_arch_from_flax,
    hat_mapping,
    state_from_flax,
)
from waifu2x_tensorrt_tpu_torch.models.hat import HAT
from waifu2x_tensorrt_tpu_torch.ops import hat_attention as ha

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark_torch" / "configs"
                     / "hat-photo-4x-bf16.json").read_text())
SMALL = dict(CONFIG, embed_dim=60, depths=[2], num_heads=2)
ARCH = {"embed_dim": 60, "depths": (2,), "num_heads": 2}


@pytest.fixture(scope="module")
def small():
    """(flat params, port fp32 module, tiles, fp32 reference output)."""
    params = weights.make_params(SMALL, 2 ** 33 + 5, "cpu")
    module = HAT(**ARCH)
    registry.load_into(module, {k: v.numpy() for k, v in params.items()})
    tiles = torch.rand((2, 48, 48, 3), generator=torch.Generator()
                       .manual_seed(3))
    with torch.no_grad():
        want = ref.forward(params, tiles, SMALL)
    return params, module, tiles, want


def _bf16_round(t):
    return t.bfloat16().float()


def test_port_matches_the_reference_fp32(small):
    params, module, tiles, want = small
    with torch.no_grad():
        got = module(tiles)
        bf16_ref = ref.forward(params, tiles, SMALL, quant=_bf16_round)
    assert got.shape == (2, 192, 192, 3)
    assert float((got - want).abs().max()) <= 3e-5
    # the tolerance sees a bf16 error
    assert float((bf16_ref - want).abs().max()) > 3e-5
    # the output spans [0, 1] and the blocks matter
    assert 0.1 < float(want.std()) < 0.5


def test_port_bf16_by_the_bf16_rule(small):
    params, _, tiles, want = small
    module = HAT(dtype=torch.bfloat16, **ARCH)
    registry.load_into(module, {k: v.numpy() for k, v in params.items()})
    with torch.no_grad():
        got = module(tiles.bfloat16()).float()
        dense = ref.forward(params, tiles, SMALL, quant=_bf16_round)
    e_port = float((got - want).abs().max())
    e_ref = float((dense - want).abs().max())
    assert e_port <= max(2 * e_ref, 0.02), (e_port, e_ref)


def _direct(qkv, table, nh, shift, overlap, ws=16):
    """softmax(q k^T d^-0.5 + bias + mask) v in float64, query by query
    over explicit token coordinates (the roll as coordinates mod H, W;
    keys outside the map as zero vectors)."""
    q64 = qkv.double()
    b, h, w, c3 = q64.shape
    c = c3 // 3
    d = c // nh
    we = ws + 2 * overlap
    tw = ws + we - 1
    out = torch.zeros((b, h, w, c), dtype=torch.float64)
    for wy in range(h // ws):
        for wx in range(w // ws):
            # query tokens: rolled (ry, rx) -> source ((ry+s)%h, (rx+s)%w)
            qy = np.repeat(np.arange(ws), ws)
            qx = np.tile(np.arange(ws), ws)
            sy, sx = (wy * ws + qy + shift) % h, (wx * ws + qx + shift) % w
            if overlap:
                ey = np.repeat(np.arange(we), we)
                ex = np.tile(np.arange(we), we)
                ky, kx = wy * ws - overlap + ey, wx * ws - overlap + ex
                inside = (ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)
                rel = ((ey[None] - qy[:, None] + ws - we + 1) * tw
                       + ex[None] - qx[:, None] + ws - we + 1)
                idx = np.where(rel < 0, rel + tw * tw, rel)
                mask = np.zeros((ws * ws, we * we))
            else:
                ky, kx, ey, ex = sy, sx, qy, qx
                inside = np.ones(ws * ws, bool)
                idx = ((qy[:, None] - ey[None] + ws - 1) * (2 * ws - 1)
                       + qx[:, None] - ex[None] + ws - 1)

                def region(r, n):  # rolled coordinate -> its slice
                    return np.where(r < n - ws, 0, np.where(r < n - shift,
                                                            1, 2))

                ry, rx = wy * ws + qy, wx * ws + qx
                reg = region(ry, h) * 3 + region(rx, w)
                mask = np.where(reg[:, None] != reg[None], -100.0, 0.0)
                if not shift:
                    mask[:] = 0.0
            kyc, kxc = np.clip(ky, 0, h - 1), np.clip(kx, 0, w - 1)
            for bi in range(b):
                kv = q64[bi, kyc, kxc, c:] * torch.from_numpy(
                    inside[:, None].astype(np.float64))
                qq = q64[bi, sy, sx, :c]
                for hd in range(nh):
                    sl = slice(hd * d, (hd + 1) * d)
                    s = (qq[:, sl] * d ** -0.5) @ kv[:, sl].T
                    s = s + table.double()[torch.from_numpy(idx), hd]
                    s = s + torch.from_numpy(mask)
                    o = s.softmax(-1) @ kv[:, c:][:, sl]
                    out[bi, sy, sx, sl] = o
    return out


@pytest.mark.parametrize("shift, overlap", [(0, 0), (8, 0), (0, 4)],
                         ids=["self", "self-shift-8", "overlapping"])
def test_kernel_g_twin_is_the_direct_attention(shift, overlap):
    g = torch.Generator().manual_seed(shift + overlap)
    nh, c = 2, 60
    qkv = torch.randn((2, 32, 48, 3 * c), generator=g)
    table = 0.5 * torch.randn((ha.table_rows(16, overlap), nh), generator=g)
    got = ha.hat_attention(qkv, table, num_heads=nh, shift=shift,
                           overlap=overlap)
    want = _direct(qkv, table, nh, shift, overlap)
    assert got.shape == (2, 32, 48, c)
    assert float((got.double() - want).abs().max()) <= 1e-5


def test_kernel_g_twin_rounds_as_the_kernel():
    """bf16: q * scale rounded to bf16 (scale rounded), fp32 softmax, p
    rounded before p v: within the bf16 rule of the fp32 twin."""
    g = torch.Generator().manual_seed(9)
    qkv = torch.randn((1, 32, 32, 180), generator=g)
    table = 0.2 * torch.randn((ha.table_rows(16, 4), 2), generator=g)
    kw = {"num_heads": 2, "overlap": 4}
    p32 = ha.hat_attention(qkv, table, **kw)
    p16 = ha.hat_attention(qkv.bfloat16(), table, **kw)
    assert p16.dtype == torch.bfloat16
    err = float((p16.float() - p32).abs().max())
    assert 0 < err <= 0.02


def test_rpi_oca_is_a_bijection_onto_the_table():
    ws, ov = 16, 4
    we = ws + 2 * ov
    idx = ha._overlap_index(ws, ov)
    n = (ws + we - 1) ** 2
    assert n == 1521 and idx.shape == (256, 576)
    oy, ox = np.divmod(np.arange(ws * ws), ws)
    ey, ex = np.divmod(np.arange(we * we), we)
    offsets = (ey[None] - oy[:, None]) * 100 + (ex[None] - ox[:, None])
    pairs = set(zip(offsets.ravel().tolist(), idx.ravel().tolist()))
    # one index an offset, one offset an index, every row of the table
    assert len(pairs) == len({o for o, _ in pairs}) == len(
        {i for _, i in pairs}) == n
    assert set(idx.ravel().tolist()) == set(range(n))
    # HAT's rule used as a Python index, as the reference uses it
    rpi = ref.rpi_oca(ws, we, "cpu").numpy()
    assert rpi.min() < 0 and np.array_equal(idx, rpi % n)
    assert np.array_equal(ha._self_index(ws), ref.rpi_sa(ws, "cpu").numpy())


def test_kernel_g_wrapper_refuses_what_it_does_not_take():
    qkv = torch.zeros((1, 32, 32, 180))
    table = torch.zeros((ha.table_rows(16, 0), 6))
    with pytest.raises(ValueError, match="multiples of the window"):
        ha.hat_attention(qkv[:, :24], table, num_heads=6)
    with pytest.raises(ValueError, match="shift"):
        ha.hat_attention(qkv, table, num_heads=6, shift=4)
    with pytest.raises(ValueError, match="table"):
        ha.hat_attention(qkv, table, num_heads=6, overlap=4)
    with pytest.raises(ValueError, match="shift"):
        ha.hat_attention(qkv, torch.zeros((ha.table_rows(16, 4), 6)),
                         num_heads=6, shift=8, overlap=4)


def test_mapping_and_checkpoint_conversion_round_trip(small, tmp_path):
    params, module, _, _ = small
    flat = {k: v.numpy() for k, v in params.items()}
    mapping = hat_mapping(ARCH["depths"])
    assert len(mapping) == 38
    # the mapping reads every array of the tree (a table is one array,
    # every other entry a weight and a bias) and gives the module's state
    assert len(flat) == sum(1 if kind == "table" else 2
                            for _, _, kind in mapping)
    state = state_from_flax(flat, mapping)
    want = module.state_dict()
    assert set(state) == set(want)
    assert all(np.array_equal(state[k], want[k].numpy()) for k in state)
    assert hat_arch_from_flax(flat) == ARCH
    path = registry.weights_path(tmp_path, "hat/photo", 4, -1)
    registry.save_params(path, flat)
    arch = registry.checkpoint_arch(path)
    assert arch == {"hat_arch": ARCH}
    # the file's widths build the module that loads it
    loaded, _ = registry.create_model("hat/photo", 4, -1, **arch)
    with np.load(path) as data:
        registry.load_into(loaded, dict(data))


def test_registry_takes_hat_photo_at_4x_without_noise():
    assert registry.MODEL_FAMILIES == ("cunet/art", "swin_unet/art",
                                       "swin_unet/art_scan",
                                       "swin_unet/photo")
    assert "hat/photo" in registry.FAMILIES
    spec = registry.get_spec("hat/photo", 4, -1)
    assert (spec.arch, spec.offset, spec.tile_divisor) == ("hat", 0, 16)
    for scale, noise in ((2, -1), (4, 0), (1, 3), (4, 3)):
        with pytest.raises(ValueError):
            registry.validate("hat/photo", scale, noise)
    with pytest.raises(ValueError, match="unknown model"):
        registry.validate("hat/art", 4, -1)
    module, _ = registry.create_model("hat/photo", 4, -1,
                                      hat_arch=dict(ARCH))
    assert isinstance(module, HAT) and not module.training
    with pytest.raises(ValueError, match="packed-x"):
        registry.create_model("hat/photo", 4, -1, packed_x_head=True,
                              hat_arch=dict(ARCH))
    flat = registry.init_params(module)
    registry.load_into(module, flat)


@pytest.mark.parametrize("option", ["tf32", "graph_exact", "onnx",
                                    "pack_x"])
def test_hat_refuses_unported_options_at_load(small, tmp_path, monkeypatch,
                                              option):
    params, *_ = small
    path = registry.weights_path(tmp_path, "hat/photo", 4, -1)
    if option == "onnx":
        path.parent.mkdir(parents=True)
        path.with_suffix(".onnx").write_bytes(b"")
    else:
        registry.save_params(path, {k: v.numpy()
                                    for k, v in params.items()})
    if option == "pack_x":
        monkeypatch.setenv("WAIFU2X_PACK_X", "1")
    cfg = RenderConfig(precision=Precision.TF32 if option == "tf32"
                       else Precision.FP16, batch_size=2, height=48,
                       width=48, scaling=4)
    want = {"tf32": "--precision tf32", "graph_exact": "--graph-exact",
            "onnx": ".onnx", "pack_x": "packed-x"}[option]
    up = Upscaler(models_dir=tmp_path, device="cpu")
    with pytest.raises(ValueError, match=want):
        up.load("hat/photo", 4, -1, cfg, graph_exact=option == "graph_exact")


def test_cli_refuses_hat_tf32_and_graph_exact(capsys):
    base = ["--model", "hat/photo", "--scale", "4", "--noise", "-1",
            "--batchSize", "4", "--tileSize", "64", "--device", "cpu"]
    assert cli.main(base + ["--precision", "tf32", "render", "-i",
                            "x.png"]) == 2
    assert "--precision tf32: not yet ported" in capsys.readouterr().err
    assert cli.main(base + ["--graph-exact", "build"]) == 2
    assert "--graph-exact: not yet ported" in capsys.readouterr().err


def test_hat_renders_through_the_upscaler(small, tmp_path):
    """Upscaler.load of a small HAT weight file (its widths read from the
    file), a rendered and a streamed 48 x 80 frame, against the reference
    render in float32: within 0.02 x 255 (the bf16 rule's floor in u8)."""
    params, *_ = small
    registry.save_params(registry.weights_path(tmp_path, "hat/photo", 4, -1),
                         {k: v.numpy() for k, v in params.items()})
    up = Upscaler(models_dir=tmp_path, device="cpu")
    up.load("hat/photo", 4, -1, RenderConfig(
        precision=Precision.FP16, batch_size=4, height=32, width=32,
        scaling=4, overlap=(1 / 16, 1 / 16)))
    frame = np.random.default_rng(4).integers(0, 256, (48, 80, 3), np.uint8)
    got = up.render(frame)
    stream = up.open_stream((48, 80))
    outs = stream.submit(frame) + stream.flush()
    want = ref_render(torch.from_numpy(frame), params,
                      dict(SMALL, tile=32)).numpy()
    assert got.shape == want.shape == (192, 320, 3)
    assert np.array_equal(np.asarray(outs[0]), got)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 0.02 * 255
