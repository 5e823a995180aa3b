"""HAT's and DAT's trunk carried at a row pitch (``models/layers.pitch``),
on the CPU.

- At the published widths (C 180, pitch 192) in bf16, every row that a
  library GEMM or convolution (``F.linear``, ``F.conv2d``) reads or
  writes is a whole number of 16-byte vectors, and starts on one, but
  for the narrow maps the pitch leaves alone (the image's 3 channels,
  HAT's C / 3 CAB map and C / 30 squeeze, DAT's C / 8 and C / 16
  interaction widths and its 1-wide spatial map); no row of C or 3C
  reaches the library.
- In the same forwards, every trunk map of pitch P (and each part of
  a 3P-wide qkv) that a library call, kernel I, G or J reads or writes
  holds exact zeros in its pad channels [C, P).
- DAT at embed 60 (pitch 64; HAT's CPU tests run at 60 already) is held
  to the benchmark's plain float32 reference by the tolerances of
  ``tests/test_torch_dat.py``.
- A width whose rows are already whole 16-byte vectors runs at P = C,
  and the meta device (the FLOP count) at P = C whatever the width.
"""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark_torch.lib import weights
from benchmark_torch.reference import dat as ref
from waifu2x_tensorrt_tpu_torch.models import dat, hat, registry
from waifu2x_tensorrt_tpu_torch.models.layers import pitch, widen

ROOT = Path(__file__).resolve().parents[1]
C = 180


def _narrow(name: str) -> set:
    """Row widths the pitch does not cover, by model."""
    if name == "hat":
        return {3, C // hat.COMPRESS, C // hat.SQUEEZE}
    return {3, 1, C // 8, C // 16}


class _Record:
    """Rows of every library call and the trunk maps of a forward."""

    def __init__(self):
        self.rows = []   # (op, what, width in values, pitch and offset
        #                  in bytes)
        self.maps = []   # (what, NHWC tensor)

    def row(self, op, what, t, pitch_values):
        e = t.element_size()
        self.rows.append((op, what, t.shape[-1 if op == "linear" else 1],
                          pitch_values * e, t.storage_offset() * e))


def _forward(name, monkeypatch):
    torch.manual_seed(0)
    model = (hat.HAT(torch.bfloat16) if name == "hat"
             else dat.DAT(torch.bfloat16))  # DAT's bias tables made here
    rec = _Record()
    linear, conv2d = F.linear, F.conv2d

    def rec_linear(x, w, b=None):
        y = linear(x, w, b)
        rec.row("linear", "in", x, x.stride(-2) if x.dim() > 1 else 0)
        rec.row("linear", "out", y, y.stride(-2) if y.dim() > 1 else 0)
        rec.maps += [("linear in", x), ("linear out", y)]
        return y

    def rec_conv2d(x, w, b=None, **kw):
        y = conv2d(x, w, b, **kw)
        rec.row("conv", "in", x, x.stride(3))
        rec.row("conv", "out", y, y.stride(3))
        rec.maps += [("conv in", x.permute(0, 2, 3, 1)),
                     ("conv out", y.permute(0, 2, 3, 1))]
        return y

    monkeypatch.setattr(F, "linear", rec_linear)
    monkeypatch.setattr(F, "conv2d", rec_conv2d)
    module = {"hat": hat, "dat": dat}[name]
    for kernel in ("add_norm", "hat_attention", "channel_attention"):
        inner = getattr(module, kernel, None)
        if inner is None:
            continue

        def recorded(*args, _inner=inner, _kernel=kernel, **kw):
            out = _inner(*args, **kw)
            for i, t in enumerate(out if isinstance(out, tuple) else (out,)):
                rec.maps.append((f"{_kernel} out {i}", t))
            return out

        monkeypatch.setattr(module, kernel, recorded)
    side = hat.WINDOW if name == "hat" else dat.TILE_DIVISOR
    with torch.no_grad():
        model(torch.rand(1, side, side, 3))
    return rec


@pytest.fixture(scope="module", params=["hat", "dat"])
def published(request):
    """(model name, the record of one bf16 forward at the published
    widths)."""
    with pytest.MonkeyPatch.context() as mp:
        return request.param, _forward(request.param, mp)


def test_library_rows_are_16_byte_aligned(published):
    name, rec = published
    p = pitch(C, "cpu")
    assert p == 192
    widths = {w for _, _, w, _, _ in rec.rows}
    assert p in widths and 3 * p in widths  # the trunk ran at its pitch
    assert not widths & {C, 3 * C}
    narrow = _narrow(name)
    for op, what, width, row, offset in rec.rows:
        if width in narrow:
            continue
        assert row % 16 == 0 and offset % 16 == 0, (op, what, width, row)


def test_trunk_pads_are_zero(published):
    _, rec = published
    p = pitch(C, "cpu")
    seen = 0
    for what, t in rec.maps:
        if t.shape[-1] not in (p, 3 * p):
            continue
        parts = t.unflatten(-1, (t.shape[-1] // p, p))
        assert not parts[..., C:].any(), what
        seen += 1
    assert seen > 100


SMALL = {"embed_dim": 60, "depths": (2, 2), "num_heads": 6,
         "expansion": 4}


def test_dat_at_a_width_off_16_bytes_matches_the_reference():
    """DAT at embed 60, carried at pitch 64, against the reference: fp32
    within 3e-5, bf16 by the bf16 rule."""
    config = dict(json.loads((ROOT / "benchmark_torch" / "configs"
                              / "dat-photo-4x-bf16.json").read_text()),
                  embed_dim=60, depths=[2, 2], num_heads=6)
    params = weights.make_params(config, 2 ** 33 + 7, "cpu")
    flat = {k: v.numpy() for k, v in params.items()}
    tiles = torch.rand((2, 32, 64, 3), generator=torch.Generator()
                       .manual_seed(5))
    assert pitch(60, "cpu") == 64
    with torch.no_grad():
        want = ref.forward(params, tiles, config)
        dense = ref.forward(params, tiles, config,
                            quant=lambda t: t.bfloat16().float())
        got = {}
        for dt in (torch.float32, torch.bfloat16):
            module = dat.DAT(dt, **SMALL)
            registry.load_into(module, flat)
            got[dt] = module(tiles.to(dt)).float()
    assert float((got[torch.float32] - want).abs().max()) <= 3e-5
    assert float((dense - want).abs().max()) > 3e-5
    e_port = float((got[torch.bfloat16] - want).abs().max())
    e_ref = float((dense - want).abs().max())
    assert e_port <= max(2 * e_ref, 0.02), (e_port, e_ref)
    assert 0.1 < float(want.std()) < 0.5


def test_a_width_of_whole_vectors_runs_unpadded(monkeypatch):
    """HAT at embed 64: every map the kernels see is 64 (or 3 x 64)
    wide; ``widen`` to the width a tensor has is the tensor itself; the
    meta device counts at P = C."""
    assert pitch(64, "cpu") == 64 and pitch(96, "cpu") == 96
    assert pitch(180, "meta") == 180 and pitch(60, "cpu") == 64
    t = torch.randn(6, 64)
    assert widen(t, 0, 3, 2) is t and widen(t, 1, 1, 64) is t
    widths = []
    inner = hat.hat_attention

    def seen(qkv, *args, **kw):
        widths.append(qkv.shape[-1])
        return inner(qkv, *args, **kw)

    monkeypatch.setattr(hat, "hat_attention", seen)
    module = hat.HAT(embed_dim=64, depths=(2,), num_heads=2)
    with torch.no_grad():
        module(torch.rand(1, 32, 32, 3))
    assert widths == [3 * 64] * 3
