"""Kernel H's plain twin (``ops/cunet_epilogue.bias_act_plain``) and the
cunet forward built on it, on the CPU.

- The twin on a bias-free conv output equals the ops it replaces, bit for
  bit: the conv's bias, then the leaky ReLU ``max(y, y * a)``, the add of
  the cropped skip and the clamp, in bf16 and fp32, for every mode cunet
  uses (``act``, ``act`` with a skip cropped by 4 or 16, the bias alone,
  a skip cropped by 20 with and without the clamp), at C 3, 32, 64, 128
  and 256. In fp32 the reference is ``F.conv2d`` with its bias. In bf16
  the CPU's oneDNN adds the bias inside the convolution, before rounding,
  where cuDNN on the card leaves it to PyTorch's ``add_`` on the rounded
  output; the reference there is that ``add_``, what the card ran.
- The twin writes over the conv output it is given and nothing else; the
  wrapper refuses shapes and dtypes that do not fit.
- ``UNet2(x, residual=True, clamp=True)`` is the cascade's crop(x, 20) +
  UNet2(x), clamped.
"""

import pytest
import torch
import torch.nn.functional as F

from waifu2x_tensorrt_tpu_torch import ops
from waifu2x_tensorrt_tpu_torch.engine import exe_cache
from waifu2x_tensorrt_tpu_torch.models import cunet
from waifu2x_tensorrt_tpu_torch.ops import cunet_epilogue as ce

MODES = [  # (act, crop of the skip or None, clamp)
    (True, None, False),
    (True, 4, False),
    (True, 16, False),
    (False, None, False),
    (False, 20, True),
    (False, 20, False),
]


def _inputs(c, crop, dtype, seed):
    """An NHWC input of 16 channels, a conv weight to ``c`` channels, its
    bias and a skip of the conv output's shape grown by ``crop`` a side."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((2, 14, 12, 16), generator=g).to(dtype)
    w = (torch.randn((c, 16, 3, 3), generator=g) / 6).to(dtype)
    b = (0.3 * torch.randn((c,), generator=g)).to(dtype)
    skip = None
    if crop is not None:
        skip = torch.randn((2, 12 + 2 * crop, 10 + 2 * crop, c),
                           generator=g).to(dtype)
    return x, w.contiguous(memory_format=torch.channels_last), b, skip


def _composed(x, w, b, *, act, skip, crop, clamp, fused_bias):
    """The ops kernel H replaces, as ``models/cunet.py`` ran them."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b if fused_bias else None)
    if not fused_bias:
        y.add_(b.reshape(1, -1, 1, 1))  # PyTorch's bias after cuDNN
    y = y.permute(0, 2, 3, 1)
    if act:
        a = float(torch.tensor(0.1, dtype=y.dtype))
        y = torch.maximum(y, y * a)
    if skip is not None:
        y = skip[:, crop:-crop, crop:-crop, :] + y
    if clamp:
        y = torch.clamp(y, 0.0, 1.0)
    return y


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("c", [3, 32, 64, 128, 256])
@pytest.mark.parametrize("act,crop,clamp", MODES,
                         ids=["act", "act-skip4", "act-skip16", "bias",
                              "skip20-clamp", "skip20"])
def test_twin_is_the_composed_ops(dtype, c, act, crop, clamp):
    x, w, b, skip = _inputs(c, crop, dtype, seed=c + (crop or 0))
    want = _composed(x, w, b, act=act, skip=skip, crop=crop, clamp=clamp,
                     fused_bias=dtype == torch.float32)
    conv = F.conv2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
    got = ce.bias_act(conv, b, act=act, skip=skip, crop=crop or 0,
                      clamp=clamp)
    assert got is conv  # in place over the conv output
    assert got.dtype == dtype and torch.equal(got, want)
    if clamp:
        assert 0 <= float(got.min()) and float(got.max()) <= 1


def test_twin_writes_out_and_leaves_c():
    """On a copy of the conv output, the twin writes over the copy alone:
    the output it returns, and the conv output and the skip as they were."""
    x, w, b, skip = _inputs(64, 4, torch.bfloat16, seed=1)
    conv = F.conv2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
    kept, skip_kept = conv.clone(), skip.clone()
    out = conv.clone()
    got = ce.bias_act_plain(out, b, skip=skip, crop=4)
    assert got is out and torch.equal(conv, kept)
    assert torch.equal(skip, skip_kept)
    assert torch.equal(out, ce.epilogue_ops(kept, b, skip=skip, crop=4))


@pytest.mark.parametrize("change,error", [
    ({"bias": torch.zeros(8)}, ValueError),
    ({"skip": torch.zeros((2, 12, 10, 64))}, ValueError),
    ({"crop": -1}, ValueError),
    ({"bias": torch.zeros(64)}, TypeError),
    ({"crop": 3}, ValueError),
])
def test_wrapper_refuses_what_does_not_fit(change, error):
    c = torch.zeros((2, 12, 10, 64), dtype=torch.bfloat16)
    kw = {"bias": torch.zeros(64, dtype=torch.bfloat16),
          "skip": torch.zeros((2, 20, 18, 64), dtype=torch.bfloat16),
          "crop": 4, **change}
    with pytest.raises(error):
        ce.bias_act(c, kw.pop("bias"), **kw)


def test_meta_tensors_take_the_twin():
    c = torch.empty((2, 12, 10, 64), device="meta")
    out = ce.bias_act(c, torch.empty(64, device="meta"),
                      skip=torch.empty((2, 20, 18, 64), device="meta"),
                      crop=4)
    assert out.shape == c.shape and out.device.type == "meta"


@pytest.mark.parametrize("clamp", [True, False])
def test_unet2_residual_is_the_cascade_sum(clamp):
    torch.manual_seed(3)
    unet2 = cunet.UNet2(3, 3)
    x = torch.rand((2, 44, 48, 3))
    with torch.no_grad():
        got = unet2(x, residual=True, clamp=clamp)
        want = x[:, 20:-20, 20:-20, :] + unet2(x)
    if clamp:
        want = torch.clamp(want, 0.0, 1.0)
    assert torch.equal(got, want)


def test_kernel_h_is_counted_under_letter_h():
    counters = ops.kernels()
    assert counters["H"] is ce.bias_act
    assert exe_cache.graph_counters()["launches_H"] == (ce.bias_act,
                                                        "launches")
