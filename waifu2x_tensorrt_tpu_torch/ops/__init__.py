"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

- ``window_attention`` — kernel A: shifted-window attention on packed qkv;
                         kernel E: the same on unpacked (BW, nh, 64, 32) heads;
- ``swin_block``       — kernel B: a whole pre-norm Swin block;
- ``finalize_epilogue``— kernel C: blend + overlap-add + u8 finalize;
- ``head_pack``        — kernel D: clamp + depth-to-space into packed-x16;
- ``mma_probe``        — kernel F: the int8/bf16 tensor-core probe;
- ``hat_attention``    — kernel G: HAT's window attention (self and
                         overlapping windows) on the qkv activation;
- ``kernel_math``      — the exact math and mask law they share (torch);
- ``build``            — nvcc build of ``csrc/`` into one ctypes library.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain PyTorch twin for CPU tensors; each counts its launches in a
``launches`` attribute. The package exports kernel E and its plain twin
under the JAX package's names, and kernel F with its plain twin.
"""

from waifu2x_tensorrt_tpu_torch.ops.mma_probe import (  # noqa: F401
    mma_probe,
    mma_probe_plain,
)
from waifu2x_tensorrt_tpu_torch.ops.window_attention import (  # noqa: F401
    fused_window_attention,
)
from waifu2x_tensorrt_tpu_torch.ops.window_attention import (  # noqa: F401
    window_attention_plain as window_attention_reference,
)
