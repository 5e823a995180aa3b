"""MambaIR (``models/mambair.py``) and kernel K's plain twin
(``ops/selective_scan.py``) on the CPU, and mambair/photo in the
registry, the converter, the Upscaler and the CLI.

The JAX package has no MambaIR, so the port is held to the benchmark's
plain float32 reference (``benchmark_torch/reference/mambair.py``,
written from the published equations), on the benchmark's seeded
weights, at a small size: embed 60 at pitch 64 (dt rank 4, D = 120, the
CAB's widths 20 and 2), d_state 4, two groups of two blocks, 16 x 24
tiles (H != W, so the row-major and column-major orders differ, and a
row is shorter than the whole sequence).

Tolerances:
- fp32, atol 3e-5: the repository's full-model fp32 tolerance; the port
  and the reference differ in how they order the scan (the twin gathers
  each direction's tokens by index, the reference flips and transposes
  the map) and in the order of fp32 sums (about 1e-6 here), while the
  reference with every product's operands rounded to bf16 misses by
  about 6e-3 (checked below, so the tolerance can see a bf16 error);
- each of three mutants of the scan (the state reset at every row of
  its order, one direction dropped, the state held in bf16) misses the
  reference by more than that tolerance, so the tolerance guards the
  scan's mathematics;
- bf16: the repository's rule |port_bf16 - ref_fp32| <= max(2
  |ref_bf16 - ref_fp32|, 0.02);
- one block's SS2D and the twin (the recurrence's closed form within
  chunks, the state carried between them) against the reference's token
  loop, and the reference's chunked closed form against its token loop,
  atol 1e-5 (fp32 sums of a few hundred terms of magnitude about 1).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark_torch.counts import mambair as counts
from benchmark_torch.lib import weights
from benchmark_torch.reference import mambair as ref
from benchmark_torch.reference import tiling
from benchmark_torch.reference.render import render as ref_render
from waifu2x_tensorrt_tpu_torch import cli
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import ChunkedPipeline
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.models import hat, mambair, registry
from waifu2x_tensorrt_tpu_torch.models.convert import (
    inv_dense_weight,
    is_dat_tree,
    is_hat_tree,
    mambair_arch_from_flax,
    mambair_from_torch,
    mambair_mapping,
    state_from_flax,
)
from waifu2x_tensorrt_tpu_torch.models.mambair import MambaIR
from waifu2x_tensorrt_tpu_torch.ops import selective_scan as ss

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark_torch" / "configs"
                     / "mambair-photo-4x-bf16.json").read_text())
SMALL = dict(CONFIG, embed_dim=60, depths=[2, 2], d_state=4)
ARCH = {"embed_dim": 60, "depths": (2, 2), "d_state": 4, "expand": 2}
TOL = 3e-5


@pytest.fixture(scope="module")
def small():
    """(flat params, port fp32 module, tiles, fp32 reference output)."""
    params = weights.make_params(SMALL, 2 ** 33 + 5, "cpu")
    module = MambaIR(**ARCH)
    registry.load_into(module, {k: v.numpy() for k, v in params.items()})
    tiles = torch.rand((2, 16, 24, 3), generator=torch.Generator()
                       .manual_seed(3))
    with torch.no_grad():
        want = ref.forward(params, tiles, SMALL)
    return params, module, tiles, want


def _bf16_round(t):
    return t.bfloat16().float()


def test_small_size_has_every_mechanism(small):
    """The widths of the small model, HAT's very CAB, and the seeded
    weights' working range: A = -1, delta about 0.01 and data-dependent,
    skip scales and D about 1."""
    _, module, _, _ = small
    blk = module.layers[1].residual_group.blocks[1]
    a = blk.self_attention
    assert (a.d_inner, a.dt_rank, a.d_state) == (120, 4, 4)
    assert mambair._CAB is hat._CAB and type(blk.conv_blk) is hat._CAB
    assert blk.conv_blk.cab[0].out_channels == 20
    assert blk.conv_blk.cab[3].attention[1].out_features == 2
    assert torch.equal(a.A_logs, torch.zeros_like(a.A_logs))
    assert torch.equal(a.dt_projs_bias,
                       torch.full_like(a.dt_projs_bias, -4.6))
    for p in (blk.skip_scale, blk.skip_scale2, a.Ds):
        assert 0.5 < float(p.detach().min()) and float(p.detach().max()) < 1.5
    # the dt projection's kernels have fan-in R: delta depends on the data
    assert 0.2 < float(a.dt_projs_weight.detach().std()) < 1.0


def test_port_matches_the_reference_fp32(small):
    params, module, tiles, want = small
    with torch.no_grad():
        got = module(tiles)
        bf16_ref = ref.forward(params, tiles, SMALL, quant=_bf16_round)
    assert got.shape == (2, 64, 96, 3)
    assert float((got - want).abs().max()) <= TOL
    # the tolerance sees a bf16 error
    assert float((bf16_ref - want).abs().max()) > TOL
    # the output spans [0, 1] and the blocks matter
    assert 0.1 < float(want.std()) < 0.5


def _bf16_state_directions(u, xdbl, dt_weight, dt_bias, a, ds, t=16):
    """``ss.scan_directions`` with the state carried between its chunks
    (of ``t`` tokens) held in bf16."""
    b, h, w, d = u.shape
    r, n = dt_weight.shape[-1], a.shape[-1]
    order = ss.scan_order(h, w)
    k = torch.arange(4)[:, None]
    us = u.float().reshape(b, h * w, d)[:, order]
    xs = xdbl.float().reshape(b, h * w, 4, r + 2 * n)[:, order, k]
    delta = F.softplus(torch.einsum("bkle,kde->bkld", xs[..., :r], dt_weight)
                       + dt_bias[:, None, :])
    bm, cm = xs[..., r:r + n], xs[..., r + n:]
    state = torch.zeros((b, 4, d, n))
    ys = torch.empty((b, 4, h * w, d))
    for s0 in range(0, h * w, t):
        dl = delta[:, :, s0:s0 + t]
        e = torch.exp(dl.cumsum(2)[..., None] * a[:, None])
        x = (dl * us[:, :, s0:s0 + t])[..., None] * bm[:, :, s0:s0 + t,
                                                       None, :]
        hs = (torch.cumsum(x / e, 2) + state[:, :, None]) * e
        ys[:, :, s0:s0 + t] = torch.einsum("bktdn,bktn->bktd", hs,
                                           cm[:, :, s0:s0 + t])
        state = hs[:, :, -1].bfloat16().float()
    return ys + ds[None, :, None, :] * us


def _row_reset_directions(u, xdbl, dt_weight, dt_bias, a, ds):
    """``ss.scan_directions`` restarted at every row of each direction's
    order: each row (row-major) and each column (column-major) scanned as
    a map of its own, with its direction's parameters."""
    b, h, w, d = u.shape
    perm = [1, 0, 3, 2]  # the column maps' directions 0 and 2 are 1 and 3
    e = xdbl.shape[-1] // 4
    rows = ss.scan_directions(u.reshape(b * h, 1, w, d),
                              xdbl.reshape(b * h, 1, w, -1), dt_weight,
                              dt_bias, a, ds)
    cols = ss.scan_directions(
        u.transpose(1, 2).reshape(b * w, 1, h, d),
        xdbl.unflatten(-1, (4, e))[..., perm, :].flatten(-2)
        .transpose(1, 2).reshape(b * w, 1, h, -1),
        dt_weight[perm], dt_bias[perm], a[perm], ds[perm])
    return torch.stack([
        rows[:, 0].reshape(b, h * w, d),
        cols[:, 0].reshape(b, h * w, d),
        rows[:, 2].reshape(b, h, w, d).flip(1).reshape(b, h * w, d),
        cols[:, 2].reshape(b, w, h, d).flip(1).reshape(b, h * w, d)], 1)


def _mutant(kind):
    """The twin with one fault: ``row`` restarts the state at every row of
    each direction's order (every W tokens row-major, every H tokens
    column-major), ``direction`` drops direction 3 from the sum, ``bf16``
    holds the state carried between chunks of 16 tokens in bf16."""
    def scan(u, xdbl, dt_weight, dt_bias, a, ds, gate):
        b, h, w, d = u.shape
        if kind == "row":
            ys = _row_reset_directions(u, xdbl, dt_weight, dt_bias, a, ds)
        elif kind == "bf16":
            ys = _bf16_state_directions(u, xdbl, dt_weight, dt_bias, a, ds)
        else:
            ys = ss.scan_directions(u, xdbl, dt_weight, dt_bias, a, ds)
            ys[:, 3] = 0.0
        return ss.combine(ys, h, w, u.dtype, gate)
    return scan


def test_row_reset_mutant_is_the_twin_on_one_row_or_column():
    """On a map of one row the row-reset mutant's row-major directions (0,
    2) are the twin's, on a map of one column its column-major ones (1,
    3): nothing to restart, so its maps, orders and parameters are in
    place."""
    ops = _scan_operands()
    for u, xdbl, ks in ((ops[0][:, :1], ops[1][:, :1], [0, 2]),
                        (ops[0][:, :, :1], ops[1][:, :, :1], [1, 3])):
        want = ss.scan_directions(u, xdbl, *ops[2:6])[:, ks]
        got = _row_reset_directions(u, xdbl, *ops[2:6])[:, ks]
        assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("kind", ["row", "direction", "bf16"])
def test_scan_mutants_fail_the_tolerance(small, monkeypatch, kind):
    """Each mutant of the scan misses the reference by more than the fp32
    tolerance the port meets."""
    params, module, tiles, want = small
    monkeypatch.setattr(mambair, "selective_scan", _mutant(kind))
    with torch.no_grad():
        got = module(tiles)
    assert float((got - want).abs().max()) > TOL


def test_port_bf16_by_the_bf16_rule(small):
    params, _, tiles, want = small
    module = MambaIR(torch.bfloat16, **ARCH)
    registry.load_into(module, {k: v.numpy() for k, v in params.items()})
    with torch.no_grad():
        got = module(tiles.bfloat16()).float()
        dense = ref.forward(params, tiles, SMALL, quant=_bf16_round)
    e_port = float((got - want).abs().max())
    e_ref = float((dense - want).abs().max())
    assert e_port <= max(2 * e_ref, 0.02), (e_port, e_ref)


def test_ss2d_and_twin_are_the_reference_token_loop(small):
    """One block's SS2D (the twin inside) against the reference's SS2D
    with its token-by-token scan, on the block's own normalised input."""
    params, module, tiles, _ = small
    n = torch.randn((2, 8, 12, 60), generator=torch.Generator()
                    .manual_seed(6))
    a = "layers/1/residual_group/blocks/0/self_attention"
    blk = module.layers[1].residual_group.blocks[0]
    with torch.no_grad():
        got = blk.self_attention(n)
        want = ref.ss2d(n, params, a, SMALL, None, scan=ref.scan_loop)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("a_scale, length, chunk", [
    (1.0, 300, 256), (16.0, 150, 16)], ids=["cell-like", "halved"])
def test_reference_chunked_scan_is_its_token_loop(a_scale, length, chunk):
    """The closed form within chunks, the state carried between them (a
    length that is no multiple of the chunk): at the seeded weights' A =
    -1 the chunk is 256 tokens; with A down to -16 and delta up to 0.3
    it halves until the decay across a chunk stays in range."""
    g = torch.Generator().manual_seed(int(a_scale))
    b, k, d, n = 2, 4, 6, 5
    us = torch.randn((b, k, length, d), generator=g)
    delta = 0.3 * torch.rand((b, k, length, d), generator=g)
    bm = torch.randn((b, k, length, n), generator=g)
    cm = torch.randn((b, k, length, n), generator=g)
    a = -a_scale * torch.rand((k, d, n), generator=g).clamp_min(0.05)
    a[0, 0, 0] = -a_scale
    assert ref.chunk_length(delta, a) == chunk
    want = ref.scan_loop(us, delta, bm, cm, a)
    got = ref.scan_chunked(us, delta, bm, cm, a)
    assert float((got - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))


def test_scan_orders_are_the_published_flips_and_transposes():
    """Direction k reads the token ``scan_order(h, w)[k, l]`` at step l:
    the published sequences (the map, its transpose, both flipped)."""
    h, w = 3, 5
    grid = torch.arange(h * w).reshape(h, w)
    rows, cols = grid.reshape(-1), grid.t().reshape(-1)
    want = torch.stack([rows, cols, rows.flip(0), cols.flip(0)])
    assert torch.equal(ss.scan_order(h, w), want)


def _scan_operands(dtype=torch.float32, d=8, r=2, n=3):
    g = torch.Generator().manual_seed(9)
    u = torch.randn((1, 3, 5, d), generator=g).to(dtype)
    xdbl = torch.randn((1, 3, 5, 4 * (r + 2 * n)), generator=g).to(dtype)
    gate = (torch.randn((1, 3, 5, d), generator=g).to(dtype),
            torch.ones(d), torch.zeros(d), 1e-5)
    return (u, xdbl, torch.randn((4, d, r), generator=g),
            torch.randn((4, d), generator=g) - 3,
            -torch.rand((4, d, n), generator=g), torch.ones((4, d)), gate)


@pytest.mark.parametrize("change, error", [
    (lambda o: (o[0][0],) + o[1:], ValueError),
    (lambda o: (o[0], o[1][..., :-4]) + o[2:], ValueError),
    (lambda o: o[:2] + (o[2][:3],) + o[3:], ValueError),
    (lambda o: o[:4] + (o[4][..., :2],) + o[5:], ValueError),
    (lambda o: o[:5] + (o[5][:, :4], o[6]), ValueError),
    (lambda o: (o[0], o[1].bfloat16()) + o[2:], TypeError),
    (lambda o: (o[0].to("meta"),) + o[1:], ValueError),
    (lambda o: o[:6] + ((o[0][:, :2], *o[6][1:]),), ValueError),
    (lambda o: o[:6] + ((o[6][0], torch.ones(6), torch.zeros(6), 1e-5),),
     ValueError),
], ids=["u-3d", "xdbl-width", "dt-weight-directions", "a-state",
        "ds-width", "xdbl-dtype", "u-device", "gate-z-shape",
        "gate-weight-width"])
def test_kernel_k_wrapper_refuses_what_does_not_fit(change, error):
    with pytest.raises(error):
        ss.selective_scan(*change(_scan_operands()))


def test_kernel_k_wrapper_takes_the_twin_on_cpu_and_nothing_on_meta():
    ops = _scan_operands()
    before = ss.selective_scan.launches
    assert torch.equal(ss.selective_scan(*ops),
                       ss.selective_scan_plain(*ops))
    z, weight, bias, eps = ops[6]
    out = ss.selective_scan(*(t.to("meta") for t in ops[:6]),
                            (z.to("meta"), weight.to("meta"),
                             bias.to("meta"), eps))
    assert out.device.type == "meta" and out.shape == ops[0].shape
    assert ss.selective_scan.launches == before
    assert ss.RANK == mambair.dt_rank(180) == 12 and ss.STATE == 16


def _published_state(module):
    """The module's state dict under MambaIR's own layout: the CAB's
    pooled-gate layers as 1x1 convs (O, I, 1, 1)."""
    state = {k: v.numpy() for k, v in module.state_dict().items()}
    for key in list(state):
        if ".attention." in key and key.endswith("weight"):
            state[key] = state[key][:, :, None, None]
    return state


def test_mapping_and_checkpoint_conversion_round_trip(small, tmp_path):
    params, module, _, _ = small
    flat = {k: v.numpy() for k, v in params.items()}
    mapping = mambair_mapping(ARCH["depths"])
    state = state_from_flax(flat, mapping)
    want = module.state_dict()
    assert set(state) == set(want)
    assert all(np.array_equal(state[k], want[k].numpy()) for k in state)
    # a checkpoint of the published layout converts to the same flat tree
    back = mambair_from_torch(_published_state(module), ARCH["depths"])
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    a = "layers.0.residual_group.blocks.0.self_attention"
    assert np.array_equal(
        inv_dense_weight(flat[a.replace(".", "/") + "/x_proj/2/kernel"]),
        want[f"{a}.x_proj_weight"][2].numpy())
    assert mambair_arch_from_flax(flat) == ARCH
    assert not is_hat_tree(flat) and not is_dat_tree(flat)
    path = registry.weights_path(tmp_path, "mambair/photo", 4, -1)
    registry.save_params(path, flat)
    arch = registry.checkpoint_arch(path)
    assert arch == {"mambair_arch": ARCH}
    loaded, _ = registry.create_model("mambair/photo", 4, -1, **arch)
    with np.load(path) as data:
        registry.load_into(loaded, dict(data))
    assert torch.equal(loaded.layers[1].residual_group.blocks[1]
                       .self_attention.A_logs,
                       module.layers[1].residual_group.blocks[1]
                       .self_attention.A_logs)


def test_registry_takes_mambair_photo_at_4x_without_noise():
    assert "mambair/photo" in registry.PORT_FAMILIES
    spec = registry.get_spec("mambair/photo", 4, -1)
    assert (spec.arch, spec.offset, spec.tile_divisor) == ("mambair", 0, 1)
    for scale, noise in ((2, -1), (4, 0), (1, 3)):
        with pytest.raises(ValueError):
            registry.validate("mambair/photo", scale, noise)
    assert registry.widths_from_file("mambair/photo")
    module, _ = registry.create_model("mambair/photo", 4, -1,
                                      mambair_arch=dict(ARCH))
    assert isinstance(module, MambaIR) and not module.training
    with pytest.raises(ValueError, match="packed-x"):
        registry.create_model("mambair/photo", 4, -1, packed_x_head=True,
                              mambair_arch=dict(ARCH))
    registry.load_into(module, registry.init_params(module))


@pytest.mark.parametrize("option", ["tf32", "graph_exact", "onnx",
                                    "pack_x"])
def test_mambair_refuses_unported_options_at_load(small, tmp_path,
                                                  monkeypatch, option):
    params, *_ = small
    path = registry.weights_path(tmp_path, "mambair/photo", 4, -1)
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
        up.load("mambair/photo", 4, -1, cfg,
                graph_exact=option == "graph_exact")
    assert "selective-scan kernel K is bf16 only" in str(err.value)


def test_cli_refuses_mambair_tf32_and_graph_exact(capsys):
    base = ["--model", "mambair/photo", "--scale", "4", "--noise", "-1",
            "--batchSize", "4", "--tileSize", "64", "--device", "cpu"]
    assert cli.main(base + ["--precision", "tf32", "render", "-i",
                            "x.png"]) == 2
    assert "--precision tf32: not yet ported" in capsys.readouterr().err
    assert cli.main(base + ["--graph-exact", "build"]) == 2
    assert "--graph-exact: not yet ported" in capsys.readouterr().err


def test_flop_count_and_kernel_i_passes_are_the_benchmarks(monkeypatch):
    """``ChunkedPipeline.flops_per_frame`` (FlopCounterMode on the meta
    device; the scan is left out there) equals ``counts/mambair``'s
    library FLOPs at the published widths on a 720 x 480 frame (6 tiles
    of 256); a forward runs kernel I 74 times (2 norms alone, 6 adds, 36
    skips, 30 skip gates) and kernel K 36."""
    c = CONFIG
    module, spec = registry.create_model(c["family"], c["scale"], c["noise"],
                                         dtype=torch.bfloat16, device="cpu")
    cfg = RenderConfig(precision=Precision(c["precision"]),
                       batch_size=c["batch"], height=c["tile"],
                       width=c["tile"], scaling=c["scale"],
                       overlap=(c["overlap"],) * 2)
    calls, scans = [], []
    inner_i, inner_k = mambair.add_norm, mambair.selective_scan

    def counting_i(x, r, w, b, eps, **kw):
        calls.append("norm" if r is None and not kw else
                     "skip_gate" if r is None else
                     "skip" if kw.get("k") is not None else "add")
        return inner_i(x, r, w, b, eps, **kw)

    def counting_k(*args, **kw):
        scans.append(args[0].shape)
        return inner_k(*args, **kw)

    monkeypatch.setattr(mambair, "add_norm", counting_i)
    monkeypatch.setattr(mambair, "selective_scan", counting_k)
    program = ChunkedPipeline(module, spec, cfg, "cpu").flops_per_frame(
        (480, 720))
    plan = tiling.plan((480, 720), c["tile"], c["scale"], 0, c["overlap"])
    per_tile = counts.library_flops_per_tile(c, c["tile"], c["tile"])
    assert plan.count == 6
    assert plan.count * per_tile == pytest.approx(program, rel=1e-9)
    assert {k: calls.count(k) for k in set(calls)} == {
        "norm": 2, "add": 6, "skip": 36, "skip_gate": 30}
    assert scans == [(6, 256, 256, 360)] * 36
    assert round(per_tile / 1e12, 3) == 2.531
    assert len(counts.scan_launches(c, 16, 256, 256)) == 36
    # a call's bytes (u, x_dbl, y) and updates at the cell's chunk
    nbytes, compute_s = counts.kernel_k(16 * 65536, c)
    assert round(nbytes / 1e6, 1) == 1879.0
    assert round(compute_s * 1e3, 4) == 2.8886


def test_mambair_renders_through_the_upscaler(small, tmp_path):
    """Upscaler.load of a small MambaIR weight file (its widths read from
    the file), a rendered and a streamed 48 x 80 frame, against the
    reference render in float32: within 0.02 x 255 (the bf16 rule's floor
    in u8)."""
    params, *_ = small
    registry.save_params(
        registry.weights_path(tmp_path, "mambair/photo", 4, -1),
        {k: v.numpy() for k, v in params.items()})
    up = Upscaler(models_dir=tmp_path, device="cpu")
    up.load("mambair/photo", 4, -1, RenderConfig(
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
