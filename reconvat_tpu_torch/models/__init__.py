"""The port's models (counterpart of `reconvat_tpu/models/__init__.py`),
imported lazily by name:

    from reconvat_tpu_torch.models.reconvat import ReconVAT
    from reconvat_tpu_torch.models.unet_onset import UNetOnset
    from reconvat_tpu_torch.models.onsets_frames import (OnsetsAndFrames,
        FrameStackVAT, OnsetStackVAT)
    from reconvat_tpu_torch.models.thickstun import Thickstun
    from reconvat_tpu_torch.models.prestack import Prestack

`MODEL_REGISTRY` holds the ported ones; the JAX package's other names raise
`NotImplementedError` in `get_model`.
"""

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
    "Prestack": ("reconvat_tpu_torch.models.prestack", "Prestack"),
}

# the JAX package's registry names that have no port yet
NOT_PORTED = (
    "Segmentation", "VATSelfAttention1D", "VATCNNAttention1D",
    "VATCNNAttentionOnsetFrame", "OnsetsAndFramesSelfAttention",
    "SimpleOnsetFrame", "StandaloneSelfAttention1D",
    "StandaloneSelfAttention2D", "Reconstructor")


def check_model_name(name: str) -> None:
    """Raise unless `name` is a ported model: NotImplementedError for a
    model of the JAX package not ported yet, KeyError for any other."""
    if name in MODEL_REGISTRY:
        return
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP §1 item 10, the "
            f"other families); ported: {sorted(MODEL_REGISTRY)}")
    raise KeyError(f"unknown model {name!r}; available: "
                   f"{sorted(MODEL_REGISTRY)}")


def get_model(name: str, **kwargs):
    """Instantiate a ported model from the registry by name."""
    import importlib

    check_model_name(name)
    module_name, cls_name = MODEL_REGISTRY[name]
    return getattr(importlib.import_module(module_name), cls_name)(**kwargs)
