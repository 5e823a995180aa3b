"""Kernel I's plain twin (``ops/hat_norm.add_norm_plain``) and the HAT
forward built on it, on the CPU.

- The twin is the op sequence ``models/hat.py`` ran before kernel I, bit
  for bit: ``x + r``, ``torch.addcmul`` with the per-image channel
  weights, then ``layers.layer_norm``, in bf16 and fp32, in all three
  variants (norm alone, add, scaled add); and MambaIR's residuals, ``x *
  k`` with the per-channel skip weight, then ``+ r`` (skip) or the
  ``addcmul`` of the CAB's map and gate (skip gate); the wrapper takes
  the twin for CPU tensors.
- ``_kernel_replay`` runs the kernel's thread mapping in numpy: a warp a
  pair of rows, lane l on 16-byte vectors l, l + 32, ..., each vector two
  quads of 4 values with the row in the pair, the channel and the image
  the kernel derives for them, the 8-byte accesses where the last pair
  has one row; sums rounded to bf16 as the kernel rounds them. Every
  value is read and written once, y equals the twin's and n is within
  one bf16 ulp of it (beyond 2^-16 of the terms its last step sums: the
  fp32 sums run in another order), at C 12, 144, 180 and 256 (1 or 2
  vectors a lane; at C 180 a vector straddles the two rows), with an odd
  row count and pairs of rows across two images.
- The wrapper refuses shapes, dtypes and devices that do not fit, and the
  kernel's own limits (bf16, C, contiguity, alignment) are checked.
- The HAT forward, its residual sums left pending to kernel I, gives the
  bytes of the forward it replaced (a copy of it below, carrying the
  trunk at the same row pitch, its LayerNorms over the real channels),
  in fp32 and bf16; a chunk of the published widths runs 86 passes of
  kernel I (2 norms alone, 48 adds, 36 scaled adds), and one group of 2
  HABs 8.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark_torch.lib import weights as bench_weights
from waifu2x_tensorrt_tpu_torch import ops
from waifu2x_tensorrt_tpu_torch.engine import exe_cache
from waifu2x_tensorrt_tpu_torch.models import hat, registry
from waifu2x_tensorrt_tpu_torch.models.layers import (
    conv,
    layer_norm,
    linear,
    pitch,
    pixel_shuffle,
)
from waifu2x_tensorrt_tpu_torch.ops import hat_norm as hn
from waifu2x_tensorrt_tpu_torch.ops.hat_attention import hat_attention

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark_torch" / "configs"
                     / "hat-photo-4x-bf16.json").read_text())
VARIANTS = ["norm", "add", "scaled", "skip", "skip_gate"]


def _inputs(shape, dtype, variant, seed):
    """x, r, z, s, an ``nn.LayerNorm`` of HAT's scale and k: a residual
    stream of std 3, terms of std 1, channel weights in (0, 0.01)
    (MambaIR's gate in (0, 1)), the skip weight k about 1 (skip
    variants)."""
    g = torch.Generator().manual_seed(seed)
    b, c = shape[0], shape[-1]
    x = (3 * torch.randn(shape, generator=g)).to(dtype)
    r = z = s = k = None
    if variant in ("add", "scaled", "skip"):
        r = torch.randn(shape, generator=g).to(dtype)
    if variant in ("scaled", "skip_gate"):
        z = torch.randn(shape, generator=g).to(dtype)
        s = ((0.01 if variant == "scaled" else 1.0)
             * torch.rand((b, c), generator=g)).to(dtype)
    if variant.startswith("skip"):
        k = (1 + 0.1 * torch.randn(c, generator=g)).to(dtype)
    norm = nn.LayerNorm(c, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        norm.bias.copy_(0.1 * torch.randn(c, generator=g))
    return x, r, z, s, norm, k


def _operands(norm, dtype):
    return norm.weight.detach().to(dtype), norm.bias.detach().to(dtype)


def _at_pitch(t, p):
    """(B, H, W, C) t carried at pitch p, NaN in its pad."""
    if t is None or t.shape[-1] == p:
        return t
    return F.pad(t, (0, p - t.shape[-1]), value=float("nan"))


@pytest.mark.parametrize("variant, pitch",
                         [(v, 180) for v in VARIANTS]
                         + [(v, 192) for v in VARIANTS],
                         ids=VARIANTS + [f"{v}-pitch-192" for v in VARIANTS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_twin_is_the_parents_ops(dtype, variant, pitch):
    """The parent's ops on C = 180 (MambaIR's: x * k first); at pitch 192
    (NaN in the inputs' pad, s (B, 192)) the same y and n on the 180 real
    channels, zeros in the pad: the LayerNorm covers the real channels
    alone."""
    x, r, z, s, norm, k = _inputs((2, 6, 5, 180), dtype, variant, seed=1)
    want = x if k is None else x * k
    if r is not None:
        want = want + r
    if z is not None:
        want = torch.addcmul(want, z, s[:, None, None, :])
    want_n = layer_norm(want, norm)
    w, b = _operands(norm, dtype)
    px, pr, pz = (_at_pitch(t, pitch) for t in (x, r, z))
    ps = None if s is None else F.pad(s, (0, pitch - 180), value=1.0)
    for fn in (hn.add_norm_plain, hn.add_norm):
        y, n = fn(px, pr, w, b, norm.eps, z=pz, s=ps, k=k)
        assert y.dtype == n.dtype == dtype
        assert y.shape == n.shape == px.shape
        assert torch.equal(y[..., :180], want)
        assert torch.equal(n[..., :180], want_n)
        assert not n[..., 180:].any()
        assert y is px or not y[..., 180:].any()
    assert (y is px) == (variant == "norm")


def _bf16(a):
    """float32 values rounded to bf16 (to nearest, ties to even), as
    float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16(
    ).float().numpy()


def _kernel_replay(x, r, z, s, w, b, eps, k=None):
    """``csrc/hat_norm.cu``'s mapping in numpy over flat bf16 maps of
    pitch P (x's channels) holding the C channels of ``w`` (and of the
    skip weight ``k``): returns (y, n) as float32 and how often each value
    was read and written."""
    bsz, hgt, wid, pitch = x.shape
    c = w.shape[0]
    rows, hw, vecs = bsz * hgt * wid, hgt * wid, pitch // 4
    nv = (vecs + 31) // 32
    flat = {k: None if t is None else t.float().reshape(-1).numpy()
            for k, t in (("x", x), ("r", r), ("z", z))}
    sv = None if s is None else s.float().reshape(-1).numpy()
    wv, bv = w.float().numpy(), b.float().numpy()
    kv = None if k is None else k.float().numpy()
    y = np.full(rows * pitch, np.nan, np.float32)
    n = np.full(rows * pitch, np.nan, np.float32)
    reads = np.zeros(rows * pitch, np.int64)
    writes = np.zeros(rows * pitch, np.int64)
    for p in range((rows + 1) // 2):
        row0 = 2 * p
        two = row0 + 1 < rows
        image = (row0 // hw, (row0 + 1) // hw if two else row0 // hw)
        quads = []  # (row in the pair, channel, flat index of value 0)
        for lane in range(32):
            for i in range(nv):
                k = lane + 32 * i
                row_of = [int(8 * k + 4 * h >= pitch) for h in range(2)]
                count = (0 if k >= vecs else 2 if two else
                         0 if row_of[0] else 1 if row_of[1] else 2)
                for h in range(count):  # the kernel's 16- or 8-byte access
                    e = 8 * k + 4 * h
                    quads.append((row_of[h], e - row_of[h] * pitch,
                                  (p * vecs + k) * 8 + 4 * h))
        vals = {}
        for row, ch, at in quads:
            idx = slice(at, at + 4)
            reads[idx] += 1
            if ch >= c:  # pad: zero, out of the sums
                vals[(row, ch, at)] = np.zeros(4, np.float32)
                continue
            v = flat["x"][idx]
            if kv is not None:
                v = _bf16(v * kv[ch:ch + 4])
            if flat["r"] is not None:
                v = _bf16(v + flat["r"][idx])
            if flat["z"] is not None:
                sc = sv[image[row] * pitch + ch:image[row] * pitch + ch + 4]
                v = _bf16(v + flat["z"][idx] * sc)
            vals[(row, ch, at)] = v
        for row in (0, 1):
            got = [(ch, at, v) for (rw, ch, at), v in vals.items()
                   if rw == row]
            if not got:
                continue
            allv = np.concatenate([v for ch, _, v in got if ch < c])
            assert allv.size == c  # the pair covers its rows
            mean = np.float32(allv.sum(dtype=np.float32) / np.float32(c))
            var = np.float32(((allv - mean) ** 2).sum(dtype=np.float32)
                             / np.float32(c))
            rstd = np.float32(1 / np.sqrt(var + np.float32(eps)))
            for ch, at, v in got:
                idx = slice(at, at + 4)
                writes[idx] += 1
                y[idx] = v
                n[idx] = 0.0 if ch >= c else _bf16(
                    wv[ch:ch + 4] * (rstd * (v - mean)) + bv[ch:ch + 4])
    return y, n, reads, writes


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape, pitch", [
    ((2, 4, 2, 12), 12), ((3, 1, 5, 180), 180), ((1, 3, 3, 144), 144),
    ((2, 1, 3, 256), 256), ((3, 1, 5, 180), 192), ((3, 1, 5, 180), 184),
    ((2, 4, 2, 12), 16)],
    ids=["c12", "c180-odd-rows", "c144-odd-rows",
         "c256-pairs-across-images", "c180-pitch-192-odd-rows",
         "c180-pitch-184-odd-rows",
         "c12-pitch-16"])
def test_kernel_replay_is_the_twin(shape, pitch, variant):
    """The replay against the twin; at a pitch P > C the inputs' pads hold
    NaN and s is (B, P): the pad is read and written once, zeros out."""
    x, r, z, s, norm, k = _inputs(shape, torch.bfloat16, variant, seed=2)
    w, b = _operands(norm, torch.bfloat16)
    x, r, z = (_at_pitch(t, pitch) for t in (x, r, z))
    s = None if s is None else F.pad(s, (0, pitch - shape[-1]), value=1.0)
    want_y, want_n = hn.add_norm_plain(x, r, w, b, norm.eps, z=z, s=s, k=k)
    y, n, reads, writes = _kernel_replay(x, r, z, s, w, b, norm.eps, k)
    assert (reads == 1).all() and (writes == 1).all()
    c = shape[-1]
    real = want_y[..., :c].float().reshape(-1).numpy()
    assert np.array_equal(y.reshape(-1, pitch)[:, :c].reshape(-1), real)
    assert not y.reshape(-1, pitch)[:, c:].any()
    # within one bf16 ulp, beyond 2^-16 of the terms the last step sums:
    # the order of the fp32 sums differs, which a value that cancels to
    # near 0 shows as many of its own ulps
    want = want_n.float().reshape(-1).numpy()
    assert not want.reshape(-1, pitch)[:, c:].any()
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
    yv = want_y[..., :c].double().reshape(-1, c)
    d = (yv - yv.mean(-1, keepdim=True)) * torch.rsqrt(
        yv.var(-1, unbiased=False, keepdim=True) + norm.eps)
    terms = F.pad((w.double() * d).abs() + b.double().abs(),
                  (0, pitch - c)).reshape(-1).numpy()
    assert (np.abs(n - want) <= ulp + 2.0 ** -16 * terms).all()


@pytest.mark.parametrize("change,error", [
    ({"x": torch.zeros((6, 180), dtype=torch.bfloat16)}, ValueError),
    ({"r": torch.zeros((2, 4, 3, 180), dtype=torch.bfloat16)}, ValueError),
    ({"z": torch.zeros((2, 4, 4, 176), dtype=torch.bfloat16)}, ValueError),
    ({"s": torch.zeros((1, 180), dtype=torch.bfloat16)}, ValueError),
    ({"weight": torch.zeros(176, dtype=torch.bfloat16)}, ValueError),
    ({"weight": torch.zeros(184, dtype=torch.bfloat16),
      "bias": torch.zeros(184, dtype=torch.bfloat16)}, ValueError),
    ({"bias": torch.zeros(180)}, TypeError),
    ({"r": torch.zeros((2, 4, 4, 180))}, TypeError),
    ({"s": None}, ValueError),
    ({"r": None}, ValueError),
    ({"z": torch.zeros((2, 4, 4, 180), dtype=torch.bfloat16,
                       device="meta")}, ValueError),
    ({"weight": torch.zeros(180, dtype=torch.bfloat16, device="meta")},
     ValueError),
    ({"k": torch.zeros(180, dtype=torch.bfloat16)}, ValueError),
    ({"k": torch.zeros(176, dtype=torch.bfloat16), "z": None, "s": None},
     ValueError),
    ({"k": torch.zeros(180), "z": None, "s": None}, TypeError),
], ids=["x-3d", "r-shape", "z-shape", "s-batch", "weight-c",
        "weight-wider-than-x", "bias-dtype",
        "r-dtype", "z-without-s", "scaled-without-r", "z-device",
        "weight-device", "skip-with-r-and-z", "k-shape", "k-dtype"])
def test_wrapper_refuses_what_does_not_fit(change, error):
    kw = {"x": torch.zeros((2, 4, 4, 180), dtype=torch.bfloat16),
          "r": torch.zeros((2, 4, 4, 180), dtype=torch.bfloat16),
          "z": torch.zeros((2, 4, 4, 180), dtype=torch.bfloat16),
          "s": torch.zeros((2, 180), dtype=torch.bfloat16),
          "weight": torch.zeros(180, dtype=torch.bfloat16),
          "bias": torch.zeros(180, dtype=torch.bfloat16), **change}
    with pytest.raises(error):
        hn.add_norm(kw.pop("x"), kw.pop("r"), kw.pop("weight"),
                    kw.pop("bias"), 1e-5, **kw)


def _aligned(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("tensors,error", [
    (lambda: (_aligned((2, 4, 4, 180), torch.float32),), TypeError),
    (lambda: (_aligned((2, 4, 4, 180), torch.float16),), TypeError),
    (lambda: (_aligned((2, 4, 4, 182)),), ValueError),
    (lambda: (_aligned((2, 4, 4, 260)),), ValueError),
    (lambda: (_aligned((2, 4, 8, 180))[:, :, ::2],), ValueError),
    (lambda: (_aligned((2, 4, 4, 180)),
              _aligned((2, 4, 4, 180)).transpose(1, 2)), ValueError),
    (lambda: (_aligned(2 * 4 * 4 * 180 + 1)[1:].view(2, 4, 4, 180),),
     ValueError),
], ids=["fp32", "fp16", "c182", "c260", "x-strided", "r-transposed",
        "x-unaligned"])
def test_kernel_limits_refuse_what_it_does_not_take(tensors, error):
    with pytest.raises(error):
        hn._check_kernel(*tensors())


def test_kernel_limits_take_the_cell_shapes():
    x = _aligned((16, 16, 16, 180))
    hn._check_kernel(x, x.clone(), x.clone(), _aligned((16, 180)),
                     _aligned(180), _aligned(180))


def test_kernel_i_is_counted_under_letter_i():
    assert ops.kernels()["I"] is hn.add_norm
    assert exe_cache.graph_counters()["launches_I"] == (hn.add_norm,
                                                        "launches")


# models/hat.py's forward before kernel I, kept here as the yardstick:
# each residual sum a torch add (or addcmul) and each LayerNorm
# ``layers.layer_norm`` on it, the trunk carried at the model's row pitch
def _ln(x, norm):
    """``layers.layer_norm`` over the real channels of a trunk map, its
    pad zero."""
    c = norm.normalized_shape[0]
    return F.pad(layer_norm(x[..., :c], norm), (0, x.shape[-1] - c))


def _parent_hab(blk, x):
    p, c = x.shape[-1], blk.norm1.normalized_shape[0]
    n = _ln(x, blk.norm1)
    cab = blk.conv_block.cab
    z = conv(F.gelu(conv(n, cab[0], pad=(p, 0, 1))), cab[2], pad=(p, 1, 0))
    ca = cab[3].attention
    w = z.mean(dim=(1, 2))
    w = torch.sigmoid(linear(F.relu(linear(w, ca[1], pad=(p, 0, 1))),
                             ca[3], pad=(p, 1, 0)))
    a = hat_attention(
        linear(n, blk.attn.qkv, pad=(p, 3, 1)),
        blk.attn.relative_position_bias_table, num_heads=blk.num_heads,
        shift=blk.shift, channels=c)
    x = torch.addcmul(x + linear(a, blk.attn.proj, pad=(p, 1, 1)), z,
                      (w * hat.CONV_SCALE)[:, None, None, :])
    return x + blk.mlp(_ln(x, blk.norm2))


def _parent_ocab(blk, x):
    p, c = x.shape[-1], blk.norm1.normalized_shape[0]
    a = hat_attention(
        linear(_ln(x, blk.norm1), blk.qkv, pad=(p, 3, 1)),
        blk.relative_position_bias_table, num_heads=blk.num_heads,
        overlap=hat.OVERLAP, channels=c)
    x = x + linear(a, blk.proj, pad=(p, 1, 1))
    return x + blk.mlp(_ln(x, blk.norm2))


def _parent_forward(m, x):
    dt = m.dtype
    x = (x.float() - m.mean).to(dt)
    p = pitch(m.embed_dim, x.device)
    f0 = conv(x, m.conv_first, pad=(p, 1, 0))
    t = _ln(f0, m.patch_embed.norm)
    for layer in m.layers:
        u = t
        for blk in layer.residual_group.blocks:
            u = _parent_hab(blk, u)
        u = _parent_ocab(layer.residual_group.overlap_attn, u)
        t = conv(u, layer.conv, pad=(p, 1, 1)) + t
    f = conv(_ln(t, m.norm), m.conv_after_body, pad=(p, 1, 1)) + f0
    u = F.leaky_relu(conv(f, m.conv_before_upsample[0], pad=(p, 0, 1)),
                     0.01)
    for i in range(0, len(m.upsample), 2):
        u = pixel_shuffle(conv(u, m.upsample[i]), 2)
    y = conv(u, m.conv_last)
    return (y.float() + m.mean).to(dt).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_hat_forward_is_the_parents_forward(dtype):
    """Two groups (2 HABs, then 1) at embed 60 (pitch 64) on the
    benchmark's seeded weights: the pending sums formed at the next
    LayerNorm give the bytes of the forward that added them in torch."""
    arch = {"embed_dim": 60, "depths": (2, 1), "num_heads": 2}
    small = dict(CONFIG, embed_dim=60, depths=[2, 1], num_heads=2)
    params = bench_weights.make_params(small, 7, "cpu")
    module = hat.HAT(dtype, **arch)
    registry.load_into(module, {k: v.numpy() for k, v in params.items()})
    tiles = torch.rand((2, 32, 48, 3), generator=torch.Generator()
                       .manual_seed(4)).to(dtype)
    with torch.no_grad():
        got = module(tiles)
        want = _parent_forward(module, tiles)
    assert float(want.float().std()) > 0.05  # the output has content
    assert torch.equal(got, want)


@pytest.mark.parametrize("depths,want", [
    ((6,) * 6, {"norm": 2, "add": 48, "scaled": 36}),
    ((2,), {"norm": 2, "add": 4, "scaled": 2}),
], ids=["published", "one-group"])
def test_hat_passes_of_kernel_i_a_chunk(depths, want, monkeypatch):
    """The kernel-I passes of a forward, on the meta device: 86 a chunk of
    the published widths, 8 for one group of 2 HABs."""
    calls = []
    inner = hat.add_norm

    def counting(x, r, w, b, eps, **scaled):
        calls.append("norm" if r is None else "scaled" if scaled else "add")
        return inner(x, r, w, b, eps, **scaled)

    monkeypatch.setattr(hat, "add_norm", counting)
    module = hat.HAT(torch.bfloat16, depths=depths, device="meta")
    with torch.no_grad():
        out = module(torch.empty((2, 32, 32, 3), device="meta"))
    assert out.shape == (2, 128, 128, 3)
    assert {k: calls.count(k) for k in want} == want
    assert len(calls) == sum(want.values())


def test_hat_refuses_an_empty_group():
    with pytest.raises(ValueError, match="depths"):
        hat.HAT(depths=(2, 0), embed_dim=60, num_heads=2)
