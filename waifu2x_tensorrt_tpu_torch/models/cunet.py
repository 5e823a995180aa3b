"""CUNet family: cascaded U-Nets for 1x denoise and 2x upscale.

The port of ``waifu2x_tensorrt_tpu.models.cunet`` (upstream waifu2x
CUNet/UpCUNet, nagadomi/nunif) as torch ``nn.Module``s. Every convolution
is VALID, so a tile loses context at its borders:

  CUNet  (scale 1): out = in - 56   (offset 28 a side)
  UpCUNet(scale 2): out = 2*in - 72 (offset 36 a side, output space)

Layout: NHWC at the module boundary, as in the JAX package; layers run
through ``models/layers.py`` (weights cast to the compute dtype once),
convolutions (cuDNN on the card) without their bias: each conv's epilogue
is one call of kernel H (``ops/cunet_epilogue.bias_act``), in place over
the conv output, which adds the bias and, where the network has them,
applies the leaky ReLU, adds the cropped skip and clamps. The numeric
choices are the reference's: leaky ReLU as ``max(x, a*x)`` with
``a = 0.1`` rounded to the compute dtype, the squeeze-and-excitation mean
accumulated in fp32 and cast back, the skip crops of 4 and 16, the
cascade crop of 20 and the [0, 1] clamp in the compute dtype.

Parameter names are upstream's (the left column of
``models/convert.cunet_mapping``): a ``UNetConv`` is
``nn.Sequential(conv, lrelu, conv, lrelu[, SEBlock])`` and the SE block
holds two 1x1 ``Conv2d`` (``conv1``, ``conv2``), which run as linear maps
on the pooled vector.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from waifu2x_tensorrt_tpu_torch.models.layers import conv, linear, weights
from waifu2x_tensorrt_tpu_torch.ops.cunet_epilogue import NEG_SLOPE, bias_act


def _conv_h(x, layer, *, act=True, skip=None, crop=0, clamp=False):
    """``layers.conv`` without its bias, then kernel H in place over its
    output: the bias, with ``act`` the leaky ReLU, with ``skip`` the add
    of ``skip`` cropped by ``crop`` a side, with ``clamp`` [0, 1]."""
    return bias_act(conv(x, layer, bias=False), weights(layer, x.dtype)[1],
                    act=act, skip=skip, crop=crop, clamp=clamp)


class SEBlock(nn.Module):
    """Squeeze-and-excitation over channels (global-mean pooled)."""

    def __init__(self, features: int, reduction: int = 8, *, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features // reduction, 1,
                               device=device)
        self.conv2 = nn.Conv2d(features // reduction, features, 1,
                               device=device)

    def forward(self, x):
        z = x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype)
        z = torch.sigmoid(linear(torch.relu(linear(z, self.conv1)),
                                 self.conv2))
        return x * z[:, None, None, :]


class UNetConv(nn.Module):
    """conv3x3 (valid) -> lrelu -> conv3x3 (valid) -> lrelu -> optional SE.
    ``self.conv`` holds upstream's Sequential (positions 1 and 3 are its
    activations; forward applies the reference's form in kernel H
    instead)."""

    def __init__(self, cin: int, mid: int, out: int, se: bool, *,
                 device=None):
        super().__init__()
        layers = [nn.Conv2d(cin, mid, 3, device=device),
                  nn.LeakyReLU(NEG_SLOPE),
                  nn.Conv2d(mid, out, 3, device=device),
                  nn.LeakyReLU(NEG_SLOPE)]
        if se:
            layers.append(SEBlock(out, device=device))
        self.conv = nn.Sequential(*layers)
        self.se = se

    def forward(self, x):
        x = _conv_h(x, self.conv[0])
        x = _conv_h(x, self.conv[2])
        return self.conv[4](x) if self.se else x


class UNet1(nn.Module):
    """Shallow U-Net; shrinks by 8 a side (conv head) or upscales 2x with
    the k4s2p3 transposed-conv head (shrinks 16 a side, output space)."""

    def __init__(self, cin: int = 3, out_channels: int = 3,
                 deconv: bool = False, *, device=None):
        super().__init__()
        kw = {"device": device}
        self.deconv = deconv
        self.conv1 = UNetConv(cin, 32, 64, se=False, **kw)
        self.conv1_down = nn.Conv2d(64, 64, 2, stride=2, **kw)
        self.conv2 = UNetConv(64, 128, 64, se=True, **kw)
        self.conv2_up = nn.ConvTranspose2d(64, 64, 2, stride=2, **kw)
        self.conv3 = nn.Conv2d(64, 64, 3, **kw)
        if deconv:
            # out = 2*in - 4: the VALID transposed conv (2*in + 2) cropped
            # by 3 a side, as padding=3 gives it
            self.conv_bottom = nn.ConvTranspose2d(64, out_channels, 4,
                                                  stride=2, padding=3, **kw)
        else:
            self.conv_bottom = nn.Conv2d(64, out_channels, 3, **kw)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = _conv_h(x1, self.conv1_down)
        x2 = self.conv2(x2)
        x2 = _conv_h(x2, self.conv2_up, skip=x1, crop=4)
        x3 = _conv_h(x2, self.conv3)
        return _conv_h(x3, self.conv_bottom, act=False)


class UNet2(nn.Module):
    """Deeper U-Net (two downsamples); shrinks by 20 a side."""

    def __init__(self, cin: int = 3, out_channels: int = 3, *, device=None):
        super().__init__()
        kw = {"device": device}
        self.conv1 = UNetConv(cin, 32, 64, se=False, **kw)
        self.conv1_down = nn.Conv2d(64, 64, 2, stride=2, **kw)
        self.conv2 = UNetConv(64, 64, 128, se=True, **kw)
        self.conv2_down = nn.Conv2d(128, 128, 2, stride=2, **kw)
        self.conv3 = UNetConv(128, 256, 128, se=True, **kw)
        self.conv3_up = nn.ConvTranspose2d(128, 128, 2, stride=2, **kw)
        self.conv4 = UNetConv(128, 64, 64, se=True, **kw)
        self.conv4_up = nn.ConvTranspose2d(64, 64, 2, stride=2, **kw)
        self.conv5 = nn.Conv2d(64, 64, 3, **kw)
        self.conv_bottom = nn.Conv2d(64, out_channels, 3, **kw)

    def forward(self, x, residual: bool = False, clamp: bool = False):
        """UNet2(x); with ``residual`` the cascade's crop(x, 20) + UNet2(x),
        with ``clamp`` clamped to [0, 1] (both in ``conv_bottom``'s
        epilogue)."""
        x1 = self.conv1(x)
        x2 = _conv_h(x1, self.conv1_down)
        x2 = self.conv2(x2)
        x3 = _conv_h(x2, self.conv2_down)
        x3 = self.conv3(x3)
        x3 = _conv_h(x3, self.conv3_up, skip=x2, crop=4)
        x4 = self.conv4(x3)
        x4 = _conv_h(x4, self.conv4_up, skip=x1, crop=16)
        x5 = _conv_h(x4, self.conv5)
        return _conv_h(x5, self.conv_bottom, act=False,
                       skip=x if residual else None, crop=20, clamp=clamp)


class CUNet(nn.Module):
    """Scale-1 cascade: UNet1 (conv head), then UNet2 refining a residual;
    out = crop(z1, 20) + UNet2(z1) = in - 56, clamped to [0, 1].
    Input: NHWC float in [0, 1], cast to ``dtype``, the compute dtype."""

    scale = 1
    offset = 28  # a side, output space

    def __init__(self, out_channels: int = 3, clamp: bool = True,
                 dtype: torch.dtype = torch.float32, *, device=None):
        super().__init__()
        self.clamp = clamp
        self.dtype = dtype
        self.unet1 = UNet1(3, out_channels, deconv=self.scale == 2,
                           device=device)
        self.unet2 = UNet2(out_channels, out_channels, device=device)

    def forward(self, x):
        z1 = self.unet1(x.to(self.dtype))
        return self.unet2(z1, residual=True, clamp=self.clamp)


class UpCUNet(CUNet):
    """Scale-2 cascade: UNet1 upscales 2x (k4s2p3 head), UNet2 refines a
    residual; out = 2*in - 72."""

    scale = 2
    offset = 36
