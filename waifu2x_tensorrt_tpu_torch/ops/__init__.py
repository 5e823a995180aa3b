"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

- ``window_attention`` — kernel A: shifted-window attention on packed qkv;
- ``swin_block``       — kernel B: a whole pre-norm Swin block;
- ``finalize_epilogue``— kernel C: blend + overlap-add + u8 finalize;
- ``kernel_math``      — the exact math and mask law they share (torch);
- ``build``            — nvcc build of ``csrc/`` into one ctypes library.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain PyTorch twin for CPU tensors; each counts its launches in a
``launches`` attribute.
"""
