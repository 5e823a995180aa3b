"""Measurement probes of the port (``python -m
waifu2x_tensorrt_tpu_torch.probes.<name>``); each needs a CUDA device.

- ``int8_probe`` — the int8 feasibility study: s8 against bf16 on the
                   tensor cores (kernel F) and through library calls.
"""
