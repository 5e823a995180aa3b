"""FLOPs of the cunet 2x forward (UpCUNet) from its shapes.

2 FLOP a multiply-add: a VALID conv 2 Hout Wout Cin Cout k^2, a transposed
conv 2 Hin Win Cin Cout k^2 (each input pixel scatters a k x k patch), the
squeeze-and-excitation dense layers 2 C (C/8) twice. Means, activations,
adds and the clamp are not counted.
"""

from __future__ import annotations


class _Walk:
    def __init__(self):
        self.flops = 0

    def conv(self, hw, cin, cout, k, stride=1):
        out = tuple((d - k) // stride + 1 for d in hw)
        self.flops += 2 * out[0] * out[1] * cin * cout * k * k
        return out

    def deconv(self, hw, cin, cout, k):
        self.flops += 2 * hw[0] * hw[1] * cin * cout * k * k
        return tuple(2 * (d - 1) + k for d in hw)

    def unet_conv(self, hw, cin, mid, out, se):
        hw = self.conv(self.conv(hw, cin, mid, 3), mid, out, 3)
        if se:
            self.flops += 2 * 2 * out * (out // 8)
        return hw


def _crop(hw, c):
    return tuple(d - 2 * c for d in hw)


def flops_per_tile(config: dict, th: int, tw: int) -> float:
    w = _Walk()
    x1 = w.unet_conv((th, tw), 3, 32, 64, False)
    x2 = w.unet_conv(w.conv(x1, 64, 64, 2, 2), 64, 128, 64, True)
    x2 = w.deconv(x2, 64, 64, 2)
    x3 = w.conv(x2, 64, 64, 3)
    z1 = _crop(w.deconv(x3, 64, 3, 4), 3)
    x1 = w.unet_conv(z1, 3, 32, 64, False)
    x2 = w.unet_conv(w.conv(x1, 64, 64, 2, 2), 64, 64, 128, True)
    x3 = w.unet_conv(w.conv(x2, 128, 128, 2, 2), 128, 256, 128, True)
    x3 = w.deconv(x3, 128, 128, 2)
    x4 = w.unet_conv(x3, 128, 64, 64, True)
    x4 = w.deconv(x4, 64, 64, 2)
    w.conv(w.conv(x4, 64, 64, 3), 64, 3, 3)
    return float(w.flops)
