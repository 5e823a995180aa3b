"""DAT (``models/dat.py``), kernel G's split rectangular windows and kernel
J's plain twin (``ops/hat_attention.py``, ``ops/channel_attention.py``)
on the CPU, and dat/photo in the registry, the converter, the Upscaler
and the CLI.

The JAX package has no DAT, so the port is held to the benchmark's plain
float32 reference (``benchmark_torch/reference/dat.py``, written from
the published equations), on the benchmark's seeded weights, at a small
size: embed 96 (6 heads of 16; position-MLP width 3, interaction widths
12 and 6), two groups of two blocks (group 0's block 0 an unshifted
spatial block, group 1's block 0 a shifted one, each group's block 1 a
channel block: every mechanism and both interaction directions), 64 x 64
tiles.

Tolerances:
- fp32, atol 3e-5: the repository's full-model fp32 tolerance; the two
  differ in the order of fp32 sums and in where the channel attention
  normalises (about 2e-6 here), while the reference with every product's
  operands rounded to bf16 misses by about 7e-3 (checked below, so the
  tolerance can see a bf16 error);
- bf16: the repository's rule |port_bf16 - ref_fp32| <= max(2
  |ref_bf16 - ref_fp32|, 0.02), ref_bf16 the reference with every
  product's operands rounded to bf16;
- the twins against direct float64 computations (explicit token
  coordinates for the windows, ``F.normalize`` and ``matmul`` for the
  channel attention), atol 1e-5: fp32 rounding of scores of magnitude
  ~10 and of 256-term and 2048-term sums.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark_torch.counts import dat as counts
from benchmark_torch.lib import weights
from benchmark_torch.reference import dat as ref
from benchmark_torch.reference import tiling
from benchmark_torch.reference.render import render as ref_render
from waifu2x_tensorrt_tpu_torch import cli
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import ChunkedPipeline
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.models import registry
from waifu2x_tensorrt_tpu_torch.models.convert import (
    dat_arch_from_flax,
    dat_from_torch,
    dat_mapping,
    is_hat_tree,
    state_from_flax,
)
from waifu2x_tensorrt_tpu_torch.models.dat import DAT, shifted
from waifu2x_tensorrt_tpu_torch.ops import channel_attention as ca
from waifu2x_tensorrt_tpu_torch.ops import hat_attention as ha

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark_torch" / "configs"
                     / "dat-photo-4x-bf16.json").read_text())
SMALL = dict(CONFIG, embed_dim=96, depths=[2, 2], num_heads=6)
ARCH = {"embed_dim": 96, "depths": (2, 2), "num_heads": 6, "expansion": 4}


@pytest.fixture(scope="module")
def small():
    """(flat params, port fp32 module, tiles, fp32 reference output)."""
    params = weights.make_params(SMALL, 2 ** 33 + 5, "cpu")
    module = DAT(**ARCH)
    registry.load_into(module, {k: v.numpy() for k, v in params.items()})
    tiles = torch.rand((2, 64, 64, 3), generator=torch.Generator()
                       .manual_seed(3))
    with torch.no_grad():
        want = ref.forward(params, tiles, SMALL)
    return params, module, tiles, want


def _bf16_round(t):
    return t.bfloat16().float()


def test_small_size_has_every_mechanism(small):
    _, module, _, _ = small
    kinds = [(type(b.attn).__name__, getattr(b.attn, "shift", None))
             for g in module.layers for b in g.blocks]
    assert kinds == [("SpatialAttention", (0, 0)),
                     ("ChannelAttention", None),
                     ("SpatialAttention", (4, 16)),
                     ("ChannelAttention", None)]
    attn = module.layers[0].blocks[0].attn
    assert attn.attns[0].pos.pos_proj.out_features == 3
    assert attn.channel_interaction[1].out_features == 12
    assert attn.spatial_interaction[0].out_features == 6


def test_port_matches_the_reference_fp32(small):
    params, module, tiles, want = small
    with torch.no_grad():
        got = module(tiles)
        bf16_ref = ref.forward(params, tiles, SMALL, quant=_bf16_round)
    assert got.shape == (2, 256, 256, 3)
    assert float((got - want).abs().max()) <= 3e-5
    # the tolerance sees a bf16 error
    assert float((bf16_ref - want).abs().max()) > 3e-5
    # the output spans [0, 1] and the blocks matter
    assert 0.1 < float(want.std()) < 0.5


def test_port_bf16_by_the_bf16_rule(small):
    params, _, tiles, want = small
    module = DAT(dtype=torch.bfloat16, **ARCH)
    registry.load_into(module, {k: v.numpy() for k, v in params.items()})
    with torch.no_grad():
        got = module(tiles.bfloat16()).float()
        dense = ref.forward(params, tiles, SMALL, quant=_bf16_round)
    e_port = float((got - want).abs().max())
    e_ref = float((dense - want).abs().max())
    assert e_port <= max(2 * e_ref, 0.02), (e_port, e_ref)


def test_the_shift_schedule_of_all_36_blocks():
    module = DAT(device="meta")
    got = {(i, j): b.attn.shift for i, g in enumerate(module.layers)
           for j, b in enumerate(g.blocks) if j % 2 == 0}
    want = {(i, j): (4, 16) if (i % 2 == 0 and j == 2)
            or (i % 2 == 1 and j in (0, 4)) else (0, 0)
            for i in range(6) for j in (0, 2, 4)}
    assert got == want
    assert sum(s != (0, 0) for s in got.values()) == 9
    assert all(shifted(i, j) == ref.shifted(i, j) for i in range(6)
               for j in range(6))
    assert all(type(b.attn).__name__ == ("SpatialAttention" if j % 2 == 0
                                         else "ChannelAttention")
               for g in module.layers for j, b in enumerate(g.blocks))


def _direct_split(qkv, table, nh, shift, split=(8, 32)):
    """DAT's two branches in float64, query by query over explicit token
    coordinates: heads [0, nh/2) on the first half of the channels in
    split windows rolled by shift, the rest in the transposed ones; bias
    (dy + wh - 1)(2 ww - 1) + dx + ww - 1; -100 between regions of the
    rolled map."""
    x = qkv.double()
    b, h, w, c3 = x.shape
    c = c3 // 3
    half, d = c // 2, c // nh
    out = torch.zeros((b, h, w, c), dtype=torch.float64)
    geos = ((split, shift), (split[::-1], shift[::-1]))
    for br, ((wh, ww), (sh, sw)) in enumerate(geos):
        def region(y, size, win, s):
            return np.where(y < size - win, 0, np.where(y < size - s, 1, 2))
        for wy in range(h // wh):
            for wx in range(w // ww):
                qy = np.repeat(np.arange(wh), ww)
                qx = np.tile(np.arange(ww), wh)
                ry, rx = wy * wh + qy, wx * ww + qx  # rolled coordinates
                sy, sx = (ry + sh) % h, (rx + sw) % w  # source tokens
                rel = ((qy[:, None] - qy[None] + wh - 1) * (2 * ww - 1)
                       + qx[:, None] - qx[None] + ww - 1)
                mask = np.zeros((wh * ww, wh * ww))
                if sh or sw:
                    reg = (region(ry, h, wh, sh) * 3
                           + region(rx, w, ww, sw))
                    mask = np.where(reg[:, None] != reg[None], -100.0, 0.0)
                for hh in range(nh // 2):
                    head = br * (nh // 2) + hh
                    ch = slice(br * half + hh * d, br * half + (hh + 1) * d)
                    q = x[:, sy, sx, ch]
                    k = x[:, sy, sx, c + ch.start:c + ch.stop]
                    v = x[:, sy, sx, 2 * c + ch.start:2 * c + ch.stop]
                    s = (q @ k.transpose(-1, -2) * d ** -0.5
                         + table.double()[rel, head] + torch.from_numpy(mask))
                    out[:, sy, sx, ch] = s.softmax(-1) @ v
    return out


@pytest.mark.parametrize("shift, pitch", [((0, 0), 24), ((4, 16), 24),
                                          ((4, 16), 32)],
                         ids=["unshifted", "shifted", "shifted-pitch-32"])
def test_kernel_g_split_twin_is_the_direct_attention(shift, pitch):
    """At a pitch of 32 (NaN in q's, k's and v's pads) the pitch-24
    output on the real channels, zeros in the pad."""
    g = torch.Generator().manual_seed(7 + shift[0])
    qkv = torch.randn((2, 64, 64, 3 * 24), generator=g)
    table = torch.randn((ha.table_rows(ha.RECT, 0), 4), generator=g)
    kw = {"num_heads": 4, "window": ha.RECT, "shift": shift, "split": True}
    wide = F.pad(qkv.unflatten(-1, (3, 24)), (0, pitch - 24),
                 value=float("nan")).flatten(-2)
    got = ha.hat_attention(wide, table, channels=24, **kw)
    want = _direct_split(qkv, table, 4, shift)
    assert got.shape == (2, 64, 64, pitch)
    assert float((got[..., :24].double() - want).abs().max()) <= 1e-5
    assert not got[..., 24:].any()
    if pitch != 24:
        assert torch.equal(got[..., :24],
                           ha.hat_attention_plain(qkv, table, **kw))


def test_split_window_index_and_mask_are_dats():
    for wh, ww in (ha.RECT, ha.RECT[::-1]):
        assert np.array_equal(ha._self_index(wh, ww),
                              ref.rpi(wh, ww, "cpu").numpy())
        want = ref.region_mask(64, 96, wh, ww, wh // 2, ww // 2, "cpu")
        got = ha.region_mask(64, 96, (wh, ww), (wh // 2, ww // 2), "cpu")
        assert torch.equal(got, want)
    assert ha.table_rows(ha.RECT, 0) == ha.table_rows(ha.RECT[::-1], 0) == 945
    # HAT's square geometry is the one it was
    assert np.array_equal(ha._self_index(16), ha._self_index(16, 16))


def test_kernel_g_wrapper_refuses_what_it_does_not_take():
    qkv = torch.zeros((1, 64, 64, 180))
    table = torch.zeros((945, 6))
    kw = {"num_heads": 6, "window": ha.RECT, "split": True}
    with pytest.raises(ValueError, match="multiples of the window"):
        ha.hat_attention(qkv[:, :48], table, **kw)
    with pytest.raises(ValueError, match="shift"):
        ha.hat_attention(qkv, table, shift=(4, 8), **kw)
    with pytest.raises(ValueError, match="even number of heads"):
        ha.hat_attention(qkv, torch.zeros((945, 5)), num_heads=5,
                         window=ha.RECT, split=True)
    with pytest.raises(ValueError, match="table"):
        ha.hat_attention(qkv, torch.zeros((961, 6)), **kw)


@pytest.mark.parametrize("tau, pitch", [(1.0, 24), (8.0, 24), (8.0, 32)],
                         ids=["1.0", "8.0", "8.0-pitch-32"])
def test_kernel_j_twin_is_normalize_and_matmul(tau, pitch):
    """At a pitch of 32 (NaN in q's, k's and v's pads) the pitch-24
    output on the real channels, zeros in the pad."""
    g = torch.Generator().manual_seed(int(tau))
    qkv = torch.randn((2, 32, 64, 3 * 24), generator=g)
    qkv[..., :48] += torch.randn((2, 1, 1, 48), generator=g)
    temp = torch.tensor([tau, 2 * tau, 0.5, 3.0])
    wide = F.pad(qkv.unflatten(-1, (3, 24)), (0, pitch - 24),
                 value=float("nan")).flatten(-2)
    got = ca.channel_attention(wide, temp, num_heads=4, channels=24)
    x = qkv.double().reshape(2, 32 * 64, 3, 4, 6).permute(2, 0, 3, 4, 1)
    q, k = F.normalize(x[0], dim=-1), F.normalize(x[1], dim=-1)
    a = (q @ k.transpose(-1, -2) * temp.double()[:, None, None]).softmax(-1)
    want = (a @ x[2]).permute(0, 3, 1, 2).reshape(2, 32, 64, 24)
    assert got.shape == (2, 32, 64, pitch)
    assert float((got[..., :24].double() - want).abs().max()) <= 1e-5
    assert not got[..., 24:].any()
    if pitch != 24:
        assert torch.equal(got[..., :24], ca.channel_attention_plain(
            qkv, temp, num_heads=4))


def test_kernel_j_twin_rounds_as_the_kernel():
    """bf16 qkv: the attention matrix rounded to bf16 before A v, one
    final rounding (the kernel's rounding points)."""
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn((1, 16, 32, 3 * 24), generator=g).bfloat16()
    temp = torch.tensor([1.0, 4.0, 8.0, 2.0])
    got = ca.channel_attention_plain(qkv, temp, num_heads=4)
    x = qkv.float().reshape(1, 512, 3, 4, 6).permute(2, 0, 3, 4, 1)
    gram = x[0] @ x[1].transpose(-1, -2)
    nq = x[0].square().sum(-1).sqrt().clamp_min(1e-12)
    nk = x[1].square().sum(-1).sqrt().clamp_min(1e-12)
    a = (temp[:, None, None] * (gram / (nq[..., :, None] * nk[..., None, :]))
         ).softmax(-1).bfloat16().float()
    want = (a @ x[2]).bfloat16().permute(0, 3, 1, 2).reshape(1, 16, 32, 24)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= float(
        want.float().abs().max()) * 2 ** -7


def test_kernel_j_wrapper_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="qkv"):
        ca.channel_attention(torch.zeros((1, 8, 8, 70)), torch.ones(6),
                             num_heads=6)
    with pytest.raises(ValueError, match="tau"):
        ca.channel_attention(torch.zeros((1, 8, 8, 72)), torch.ones(4),
                             num_heads=6)


def test_batchnorm_folding_is_batchnorm_eval():
    """``dat_from_torch`` folds each BatchNorm's running statistics into
    the inference form the port holds: x scale + bias equals
    ``nn.BatchNorm2d.eval()``; the folded tree loads and the module's
    conv branch equals conv, BatchNorm2d and GELU in torch."""
    module = DAT(embed_dim=96, depths=(1,), num_heads=6)
    src = {k: v.clone() for k, v in module.state_dict().items()}
    g = torch.Generator().manual_seed(11)
    bns = [s for s, _, kind in dat_mapping((1,)) if kind == "bn"]
    assert len(bns) == 3
    for name in bns:
        c = src[f"{name}.weight"].numel()
        src[f"{name}.weight"] = 1 + 0.3 * torch.randn(c, generator=g)
        src[f"{name}.bias"] = 0.3 * torch.randn(c, generator=g)
        src[f"{name}.running_mean"] = torch.randn(c, generator=g)
        src[f"{name}.running_var"] = torch.rand(c, generator=g) + 0.1
        src[f"{name}.num_batches_tracked"] = torch.tensor(100)
    flat = dat_from_torch(src, (1,))
    name = "layers.0.blocks.0.attn.dwconv.1"
    bn = torch.nn.BatchNorm2d(96).eval()
    bn.load_state_dict({k.split(".")[-1]: v for k, v in src.items()
                        if k.startswith(name + ".")})
    x = torch.randn((2, 96, 5, 7), generator=g)
    scale = torch.from_numpy(flat[name.replace(".", "/") + "/scale"])
    bias = torch.from_numpy(flat[name.replace(".", "/") + "/bias"])
    with torch.no_grad():
        want = bn(x)
    got = x * scale[:, None, None] + bias[:, None, None]
    assert float((got - want).abs().max()) <= 1e-5
    registry.load_into(module, flat)
    attn = module.layers[0].blocks[0].attn
    qkv = torch.randn((2, 32, 32, 288), generator=g)
    conv = torch.nn.Conv2d(96, 96, 3, padding=1, groups=96)
    conv.load_state_dict({"weight": src[f"{name[:-2]}.0.weight"],
                          "bias": src[f"{name[:-2]}.0.bias"]})
    with torch.no_grad():
        want = F.gelu(bn(conv(qkv[..., 192:].permute(0, 3, 1, 2))))
        got = attn.conv_branch(qkv)
    assert float((got - want.permute(0, 2, 3, 1)).abs().max()) <= 1e-5


def test_mapping_and_checkpoint_conversion_round_trip(small, tmp_path):
    params, module, _, _ = small
    flat = {k: v.numpy() for k, v in params.items()}
    mapping = dat_mapping(ARCH["depths"])
    # the mapping reads every array of the tree (a table is one array,
    # every other entry a weight and a bias) and gives the module's state
    assert len(flat) == sum(1 if kind == "table" else 2
                            for _, _, kind in mapping)
    state = state_from_flax(flat, mapping)
    want = module.state_dict()
    assert set(state) == set(want)
    assert all(np.array_equal(state[k], want[k].numpy()) for k in state)
    assert dat_arch_from_flax(flat) == ARCH
    assert not is_hat_tree(flat)
    path = registry.weights_path(tmp_path, "dat/photo", 4, -1)
    registry.save_params(path, flat)
    arch = registry.checkpoint_arch(path)
    assert arch == {"dat_arch": ARCH}
    loaded, _ = registry.create_model("dat/photo", 4, -1, **arch)
    with np.load(path) as data:
        registry.load_into(loaded, dict(data))
    # the position tables follow the loaded weights
    assert torch.equal(loaded.layers[1].blocks[0].attn.table,
                       module.layers[1].blocks[0].attn.table)


def test_registry_takes_dat_photo_at_4x_without_noise():
    assert registry.MODEL_FAMILIES == ("cunet/art", "swin_unet/art",
                                       "swin_unet/art_scan",
                                       "swin_unet/photo")
    assert registry.PORT_FAMILIES == ("hat/photo", "dat/photo")
    spec = registry.get_spec("dat/photo", 4, -1)
    assert (spec.arch, spec.offset, spec.tile_divisor) == ("dat", 0, 32)
    for scale, noise in ((2, -1), (4, 0), (1, 3), (4, 3)):
        with pytest.raises(ValueError):
            registry.validate("dat/photo", scale, noise)
    assert registry.widths_from_file("dat/photo")
    assert not registry.widths_from_file("cunet/art")
    module, _ = registry.create_model("dat/photo", 4, -1,
                                      dat_arch=dict(ARCH))
    assert isinstance(module, DAT) and not module.training
    with pytest.raises(ValueError, match="packed-x"):
        registry.create_model("dat/photo", 4, -1, packed_x_head=True,
                              dat_arch=dict(ARCH))
    registry.load_into(module, registry.init_params(module))


@pytest.mark.parametrize("option", ["tf32", "graph_exact", "onnx",
                                    "pack_x"])
def test_dat_refuses_unported_options_at_load(small, tmp_path, monkeypatch,
                                              option):
    params, *_ = small
    path = registry.weights_path(tmp_path, "dat/photo", 4, -1)
    if option == "onnx":
        path.parent.mkdir(parents=True)
        path.with_suffix(".onnx").write_bytes(b"")
    else:
        registry.save_params(path, {k: v.numpy()
                                    for k, v in params.items()})
    if option == "pack_x":
        monkeypatch.setenv("WAIFU2X_PACK_X", "1")
    cfg = RenderConfig(precision=Precision.TF32 if option == "tf32"
                       else Precision.FP16, batch_size=2, height=64,
                       width=64, scaling=4)
    want = {"tf32": "--precision tf32", "graph_exact": "--graph-exact",
            "onnx": ".onnx", "pack_x": "packed-x"}[option]
    up = Upscaler(models_dir=tmp_path, device="cpu")
    with pytest.raises(ValueError, match=want) as err:
        up.load("dat/photo", 4, -1, cfg, graph_exact=option == "graph_exact")
    assert "kernels G and J are bf16 only" in str(err.value)


def test_cli_refuses_dat_tf32_and_graph_exact(capsys):
    base = ["--model", "dat/photo", "--scale", "4", "--noise", "-1",
            "--batchSize", "4", "--tileSize", "64", "--device", "cpu"]
    assert cli.main(base + ["--precision", "tf32", "render", "-i",
                            "x.png"]) == 2
    assert "--precision tf32: not yet ported" in capsys.readouterr().err
    assert cli.main(base + ["--graph-exact", "build"]) == 2
    assert "--graph-exact: not yet ported" in capsys.readouterr().err


def test_flop_count_is_the_benchmarks():
    """``ChunkedPipeline.flops_per_frame`` (FlopCounterMode on the meta
    device, kernels G and J through their twins) equals ``counts/dat`` at
    the published widths on a 720 x 480 frame (6 tiles of 256)."""
    c = CONFIG
    module, spec = registry.create_model(c["family"], c["scale"], c["noise"],
                                         dtype=torch.bfloat16, device="cpu")
    cfg = RenderConfig(precision=Precision(c["precision"]),
                       batch_size=c["batch"], height=c["tile"],
                       width=c["tile"], scaling=c["scale"],
                       overlap=(c["overlap"],) * 2)
    program = ChunkedPipeline(module, spec, cfg, "cpu").flops_per_frame(
        (480, 720))
    plan = tiling.plan((480, 720), c["tile"], c["scale"], 0, c["overlap"])
    per_tile = counts.flops_per_tile(c, c["tile"], c["tile"])
    assert plan.count == 6
    assert plan.count * per_tile == pytest.approx(program, rel=1e-9)
    assert round(per_tile / 1e12, 3) == 2.186
    assert len(counts.attention_launches(c, 16, 256, 256)) == 18
    assert counts.attention_launches(c, 16, 256, 256)[0] == (4096, "rect")
    assert counts.channel_launches(c, 16, 256, 256) == [16 * 65536] * 18
    # 4 x 377.5 MB a launch of either kernel
    for nbytes in (counts.kernel_g(4096, "rect", c)[1],
                   counts.kernel_j(16 * 65536, c)[1]):
        assert round(nbytes / 4 / 1e6, 1) == 377.5


def test_dat_renders_through_the_upscaler(small, tmp_path):
    """Upscaler.load of a small DAT weight file (its widths read from the
    file), a rendered and a streamed 48 x 80 frame, against the reference
    render in float32: within 0.02 x 255 (the bf16 rule's floor in u8)."""
    params, *_ = small
    registry.save_params(registry.weights_path(tmp_path, "dat/photo", 4, -1),
                         {k: v.numpy() for k, v in params.items()})
    up = Upscaler(models_dir=tmp_path, device="cpu")
    up.load("dat/photo", 4, -1, RenderConfig(
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
