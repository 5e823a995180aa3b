"""The waifu2x ``swin_unet`` family as torch modules, its registry and the
flax-to-torch weight bridge (``cunet`` is not ported yet)."""

from waifu2x_tensorrt_tpu_torch.models.registry import (  # noqa: F401
    MODEL_FAMILIES,
    ModelSpec,
    create_model,
    get_spec,
    model_file_stem,
)
