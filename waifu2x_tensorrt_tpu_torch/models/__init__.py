"""The waifu2x ``swin_unet`` and ``cunet`` families, HAT (``hat``), DAT
(``dat``) and MambaIR (``mambair``) as torch modules, their registry and
the flax-to-torch weight bridge."""

from waifu2x_tensorrt_tpu_torch.models.registry import (  # noqa: F401
    MODEL_FAMILIES,
    ModelSpec,
    create_model,
    get_spec,
    model_file_stem,
)
