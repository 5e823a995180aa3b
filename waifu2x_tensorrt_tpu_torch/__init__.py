"""waifu2x_tensorrt_tpu_torch — the PyTorch/CUDA port of waifu2x_tensorrt_tpu.

The same upscaler for one NVIDIA Hopper GPU (sm_90a). Module paths mirror
the JAX package so each counterpart is easy to find:

- ``tiling``        — tile grids and seam blend weights (numpy only)
- ``models``        — swin_unet as torch ``nn.Module``s, registry and the
                      flax-to-torch weight bridge
- ``ops``           — hand-written CUDA kernels (``ops/csrc``), each with a
                      plain PyTorch twin and a launch counter
- ``engine``        — Upscaler facade, chunked pipeline and tile streaming
- ``io``            — still-image read/write and input discovery
- ``utils``         — logging/progress callbacks, timing

The package imports torch and never jax; the JAX package stays the
reference it is tested against.
"""

__version__ = "0.1.0"

from waifu2x_tensorrt_tpu_torch.engine.config import (  # noqa: F401
    BuildConfig,
    Precision,
    RenderConfig,
)
