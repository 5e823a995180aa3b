"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

- ``window_attention`` — kernel A: shifted-window attention on packed qkv;
                         kernel E: the same on unpacked (BW, nh, 64, 32) heads;
- ``swin_block``       — kernel B: a whole pre-norm Swin block;
- ``finalize_epilogue``— kernel C: blend + overlap-add + u8 finalize;
- ``head_pack``        — kernel D: clamp + depth-to-space into packed-x16;
- ``mma_probe``        — kernel F: the int8/bf16 tensor-core probe;
- ``hat_attention``    — kernel G: HAT's window attention (self and
                         overlapping windows) on the qkv activation;
- ``cunet_epilogue``   — kernel H: cunet's conv epilogue (bias, leaky
                         ReLU, cropped skip add, clamp) in one pass;
- ``hat_norm``         — kernel I: HAT's residual sums and their LayerNorm
                         in one pass;
- ``kernel_math``      — the exact math and mask law they share (torch);
- ``build``            — nvcc build of ``csrc/`` into one ctypes library.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain PyTorch twin for CPU tensors; each counts its launches in a
``launches`` attribute, and ``kernels()`` lists the wrappers by letter.
The package exports kernel E and its plain twin under the JAX package's
names, and kernel F with its plain twin.
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


def kernels() -> dict:
    """The kernel wrappers by letter, A-I. Each counts its launches in
    ``.launches``; a wrapper with ``extra_counters`` ({name: attribute})
    counts some of them once more in each such attribute."""
    # imported here: a name bound in this package would hide the
    # submodule of the same name (``ops.hat_attention``)
    from waifu2x_tensorrt_tpu_torch.ops.cunet_epilogue import bias_act
    from waifu2x_tensorrt_tpu_torch.ops.finalize_epilogue import (
        finalize_gather,
    )
    from waifu2x_tensorrt_tpu_torch.ops.hat_attention import hat_attention
    from waifu2x_tensorrt_tpu_torch.ops.hat_norm import add_norm
    from waifu2x_tensorrt_tpu_torch.ops.head_pack import pack_head_x16
    from waifu2x_tensorrt_tpu_torch.ops.swin_block import fused_swin_block
    from waifu2x_tensorrt_tpu_torch.ops.window_attention import (
        fused_window_attention_qkv,
    )

    return {"A": fused_window_attention_qkv, "B": fused_swin_block,
            "C": finalize_gather, "D": pack_head_x16,
            "E": fused_window_attention, "F": mma_probe, "G": hat_attention,
            "H": bias_act, "I": add_norm}
