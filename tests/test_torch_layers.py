"""The models' operand cache (``models/layers.py``), on the CPU.

After its first forward no model casts or re-lays a parameter, so a CUDA
graph captured after that forward replays none: under a
``TorchDispatchMode``, a second forward (in inference mode, as the
program store runs it) makes no ``aten._to_copy``, ``aten.clone`` or
``aten.copy_`` whose source lies in a parameter's storage, nor an
``aten.to`` or ``aten.contiguous`` that copies (the mode sees those
before they become the first two in inference mode), while the first
forward makes some (so the mode sees them). For swin_unet (fused and
unfused blocks), cunet 1x and 2x, HAT, DAT and MambaIR at the CPU tests'
small widths, in fp32 and bf16.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from waifu2x_tensorrt_tpu_torch.models import registry

SWIN = dict(base_dim=32, depths=(2, 2, 2, 2, 2))
HAT = dict(hat_arch={"embed_dim": 60, "depths": (2,), "num_heads": 2})
DAT = dict(dat_arch={"embed_dim": 96, "depths": (2,), "num_heads": 6})
MAMBAIR = dict(mambair_arch={"embed_dim": 60, "depths": (2,), "d_state": 4})
# name: ((family, scale, noise), create_model options, tile)
MODELS = {
    "swin_unet": (("swin_unet/art", 2, 1), SWIN, 32),
    "swin_unet-fused": (("swin_unet/art", 2, 1),
                        dict(SWIN, fused_block=True), 32),
    "cunet-1x": (("cunet/art", 1, 1), {}, 72),
    "cunet-2x": (("cunet/art", 2, 1), {}, 48),
    "hat": (("hat/photo", 4, -1), HAT, 32),
    "dat": (("dat/photo", 4, -1), DAT, 32),
    "mambair": (("mambair/photo", 4, -1), MAMBAIR, 16),
}

aten = torch.ops.aten
# op: the argument that is its source
_SOURCE = {aten._to_copy: 0, aten.clone: 0, aten.copy_: 1, aten.to: 0,
           aten.contiguous: 0}


class _ParameterCopies(TorchDispatchMode):
    """Records every copy whose source lies in one of ``params``'
    storages."""

    def __init__(self, params):
        super().__init__()
        self.storages = {p.untyped_storage().data_ptr() for p in params}
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        i = _SOURCE.get(func.overloadpacket)
        if i is not None:
            src = args[i].untyped_storage().data_ptr()
            if src in self.storages and (
                    func.overloadpacket is aten.copy_
                    or out.untyped_storage().data_ptr() != src):
                self.seen.append(func)
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", MODELS)
def test_a_forward_after_the_first_copies_no_parameter(name, dtype):
    (family, scale, noise), options, tile = MODELS[name]
    module, _ = registry.create_model(family, scale, noise, dtype=dtype,
                                      **options)
    x = torch.rand(2, tile, tile, 3)
    params = list(module.parameters())
    with torch.inference_mode():
        with _ParameterCopies(params) as first:
            module(x)
        with _ParameterCopies(params) as later:
            module(x)
    assert first.seen
    assert later.seen == []
