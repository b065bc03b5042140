"""The port's models (counterpart of `reconvat_tpu/models/__init__.py`),
imported lazily by name:

    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.models.unet_onset import UNetOnset
    from reconvat_tpu_torch.models.onsets_frames import (OnsetsAndFrames,
        FrameStackVAT, OnsetStackVAT)
    from reconvat_tpu_torch.models.thickstun import Thickstun
    from reconvat_tpu_torch.models.segmentation import SemanticSegmentation
    from reconvat_tpu_torch.models.prestack import Prestack
    from reconvat_tpu_torch.models.attention_models import (
        VATSelfAttention1D, VATCNNAttention1D, VATCNNAttentionOnsetFrame,
        OnsetsAndFramesSelfAttention, SimpleOnsetFrame,
        StandaloneSelfAttention1D, StandaloneSelfAttention2D, Reconstructor)

`MODEL_REGISTRY` holds every name of the JAX package's registry.
"""

_ATTN = "reconvat_tpu_torch.models.attention_models"

MODEL_REGISTRY = {
    "ReconVAT": ("reconvat_tpu_torch.models.reconvat", "ReconVAT"),
    "UNet_Onset": ("reconvat_tpu_torch.models.unet_onset", "UNetOnset"),
    "OnsetsAndFrames": ("reconvat_tpu_torch.models.onsets_frames",
                        "OnsetsAndFrames"),
    "FrameStack": ("reconvat_tpu_torch.models.onsets_frames",
                   "FrameStackVAT"),
    "OnsetStack": ("reconvat_tpu_torch.models.onsets_frames",
                   "OnsetStackVAT"),
    "Thickstun": ("reconvat_tpu_torch.models.thickstun", "Thickstun"),
    "Segmentation": ("reconvat_tpu_torch.models.segmentation",
                     "SemanticSegmentation"),
    "Prestack": ("reconvat_tpu_torch.models.prestack", "Prestack"),
    **{name: (_ATTN, name) for name in (
        "VATSelfAttention1D", "VATCNNAttention1D",
        "VATCNNAttentionOnsetFrame", "OnsetsAndFramesSelfAttention",
        "SimpleOnsetFrame", "StandaloneSelfAttention1D",
        "StandaloneSelfAttention2D", "Reconstructor")},
}

# the JAX package's registry names that have no port yet: none
NOT_PORTED = ()


def check_model_name(name: str) -> None:
    """Raise KeyError unless `name` is in the registry."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}")


def get_model(name: str, **kwargs):
    """Instantiate a ported model from the registry by name."""
    import importlib

    check_model_name(name)
    module_name, cls_name = MODEL_REGISTRY[name]
    return getattr(importlib.import_module(module_name), cls_name)(**kwargs)
