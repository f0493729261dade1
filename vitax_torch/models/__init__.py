"""The ViT model (vitax_torch/models/vit.py)."""

from vitax_torch.models.vit import (  # noqa: F401
    Attention,
    Block,
    DropoutSeeds,
    Mlp,
    PatchEmbed,
    VisionTransformer,
    build_model,
    count_params,
    expected_param_count,
)
