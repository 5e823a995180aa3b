"""Plain reference of the cunet 2x upscaler (UpCUNet), float32.

nagadomi's waifu2x ``cunet`` (nunif ``waifu2x/models/cunet.py``): two
cascaded U-Nets with VALID 3x3 convolutions. UNet1 upscales 2x with a
k4 s2 transposed conv cropped by 3 a side; UNet2 refines a residual;
out = crop(z1, 20) + UNet2(z1), clamped to [0, 1]: 2 in - 72 output
pixels for ``in`` input pixels. A UNetConv is conv, leaky ReLU 0.1, conv,
leaky ReLU 0.1 and, where marked, squeeze-and-excitation (global mean,
dense to C/8, ReLU, dense to C, sigmoid, scale). Parameters are the
flat published layout of the program's weight files: conv and
transposed-conv kernels (kH, kW, in, out), a transposed conv's taps
applied unflipped (flax ``ConvTranspose``), dense kernels (in, out).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (name, in, mid, out, squeeze-and-excitation)
_UNET1 = (("conv1", 3, 32, 64, False), ("conv2", 64, 128, 64, True))
_UNET2 = (("conv1", 3, 32, 64, False), ("conv2", 64, 64, 128, True),
          ("conv3", 128, 256, 128, True), ("conv4", 128, 64, 64, True))


def offset(config: dict) -> int:
    return 36


def param_shapes(config: dict) -> dict:
    shapes = {}

    def conv(name, cin, cout, k):
        shapes[f"{name}/kernel"] = (k, k, cin, cout)
        shapes[f"{name}/bias"] = (cout,)

    for net, convs in (("unet1", _UNET1), ("unet2", _UNET2)):
        for name, cin, mid, out, se in convs:
            conv(f"{net}/{name}/conv0", cin, mid, 3)
            conv(f"{net}/{name}/conv1", mid, out, 3)
            if se:
                shapes[f"{net}/{name}/se/fc1/kernel"] = (out, out // 8)
                shapes[f"{net}/{name}/se/fc1/bias"] = (out // 8,)
                shapes[f"{net}/{name}/se/fc2/kernel"] = (out // 8, out)
                shapes[f"{net}/{name}/se/fc2/bias"] = (out,)
    conv("unet1/conv1_down", 64, 64, 2)
    conv("unet1/conv2_up", 64, 64, 2)
    conv("unet1/conv3", 64, 64, 3)
    conv("unet1/conv_bottom", 64, 3, 4)
    conv("unet2/conv1_down", 64, 64, 2)
    conv("unet2/conv2_down", 128, 128, 2)
    conv("unet2/conv3_up", 128, 128, 2)
    conv("unet2/conv4_up", 64, 64, 2)
    conv("unet2/conv5", 64, 64, 3)
    conv("unet2/conv_bottom", 64, 3, 3)
    return shapes


def _q(t, quant):
    return t if quant is None else quant(t)


def _conv(x, p, name, quant, stride=1):
    k = p[f"{name}/kernel"].permute(3, 2, 0, 1)
    return F.conv2d(_q(x, quant), _q(k, quant), p[f"{name}/bias"],
                    stride=stride)


def _deconv(x, p, name, quant):
    """VALID transposed conv, stride 2, the kernel's taps unflipped."""
    k = p[f"{name}/kernel"].flip(0, 1).permute(2, 3, 0, 1)
    return F.conv_transpose2d(_q(x, quant), _q(k, quant), p[f"{name}/bias"],
                              stride=2)


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _crop(x, c):
    return x[:, :, c:-c, c:-c]


def _unet_conv(x, p, name, se, quant):
    x = _lrelu(_conv(x, p, f"{name}/conv0", quant))
    x = _lrelu(_conv(x, p, f"{name}/conv1", quant))
    if not se:
        return x
    z = x.mean(dim=(2, 3))
    z = torch.relu(_q(z, quant) @ _q(p[f"{name}/se/fc1/kernel"], quant)
                   + p[f"{name}/se/fc1/bias"])
    z = torch.sigmoid(_q(z, quant) @ _q(p[f"{name}/se/fc2/kernel"], quant)
                      + p[f"{name}/se/fc2/bias"])
    return x * z[:, :, None, None]


def _unet1(x, p, quant):
    x1 = _unet_conv(x, p, "unet1/conv1", False, quant)
    x2 = _lrelu(_conv(x1, p, "unet1/conv1_down", quant, stride=2))
    x2 = _unet_conv(x2, p, "unet1/conv2", True, quant)
    x2 = _lrelu(_deconv(x2, p, "unet1/conv2_up", quant))
    x3 = _lrelu(_conv(_crop(x1, 4) + x2, p, "unet1/conv3", quant))
    return _crop(_deconv(x3, p, "unet1/conv_bottom", quant), 3)


def _unet2(x, p, quant):
    x1 = _unet_conv(x, p, "unet2/conv1", False, quant)
    x2 = _lrelu(_conv(x1, p, "unet2/conv1_down", quant, stride=2))
    x2 = _unet_conv(x2, p, "unet2/conv2", True, quant)
    x3 = _lrelu(_conv(x2, p, "unet2/conv2_down", quant, stride=2))
    x3 = _unet_conv(x3, p, "unet2/conv3", True, quant)
    x3 = _lrelu(_deconv(x3, p, "unet2/conv3_up", quant))
    x4 = _unet_conv(_crop(x2, 4) + x3, p, "unet2/conv4", True, quant)
    x4 = _lrelu(_deconv(x4, p, "unet2/conv4_up", quant))
    x5 = _lrelu(_conv(_crop(x1, 16) + x4, p, "unet2/conv5", quant))
    return _conv(x5, p, "unet2/conv_bottom", quant)


def forward(p: dict, tiles: torch.Tensor, config: dict, quant=None):
    """(N, h, w, 3) float32 in [0, 1] -> (N, 2h - 72, 2w - 72, 3)."""
    x = tiles.permute(0, 3, 1, 2)
    z1 = _unet1(x, p, quant)
    z = torch.clamp(_crop(z1, 20) + _unet2(z1, p, quant), 0.0, 1.0)
    return z.permute(0, 2, 3, 1)
