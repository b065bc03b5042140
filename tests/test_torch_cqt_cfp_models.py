"""Every family of the port's registry on the CQT and CFP frontends against
the JAX package, on the CPU (ReconVAT's are in
tests/test_torch_cqt_cfp.py), and the CFP refusal of every model's
`run_on_batch`.

Every model of the registry that transcribes (all but the Reconstructor)
transcribes one 40-frame clip (numpy seed) on each frontend: their widths
follow the frontend's 176 or 386 bins, never 229. FrameStack and
OnsetStack are held against the JAX package's eval forward on its
`transcribe_spec`, because their JAX `transcribe` unpacks three outputs
from their two and one (ROADMAP, "Known on the JAX side"); the port
returns their one roll as both rolls. Tolerance: atol 1e-4, rtol 1e-4 on
the posteriograms, fp32 on both sides, as the families' own tests hold
them on the Mel frontend. CFP gives T - 2 frames in both packages.

Weights: the port's seeded init, read by the JAX package's loader from a
`.pt` (or `torch_to_flax` with the O&F trunk's names for the attention
models, as tests/test_torch_attention_models.py), perturbed, and carried
back (`flax_to_torch`). The JAX sides are jitted.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu.models import get_model as jax_get_model
from reconvat_tpu.models.common import transcribe_spec as jax_transcribe_spec
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch.models import MODEL_REGISTRY, get_model
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_attention_models import _jax_names
from .test_torch_reconvat import _perturb
from .torch_threads import torch_one_thread  # noqa: F401

ATOL = RTOL = 1e-4
FRAMES = 40
# registry name -> (JAX keys beside spec, the JAX package loads the .pt)
FAMILIES = {
    "UNet_Onset": ({"conv_layout": "nhwc"}, True),
    "OnsetsAndFrames": ({}, True),
    "FrameStack": ({}, True),
    "OnsetStack": ({}, True),
    "Thickstun": ({}, True),
    "Prestack": ({}, True),
    "Segmentation": ({"conv_layout": "nhwc"}, True),
    **{name: ({}, False) for name in (
        "VATSelfAttention1D", "VATCNNAttention1D",
        "VATCNNAttentionOnsetFrame", "OnsetsAndFramesSelfAttention",
        "SimpleOnsetFrame", "StandaloneSelfAttention1D",
        "StandaloneSelfAttention2D")},
}
# the ablations' JAX rolls from their eval forward's outputs
ABLATION_ROLLS = {"FrameStack": lambda outs: (outs[-1], outs[-1]),
                  "OnsetStack": lambda outs: (outs, outs)}


def _template(jmodel):
    frames = 8 if type(jmodel).__name__ == "Prestack" else 32
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           seq_frames=frames)))


@pytest.mark.parametrize("spec", ["CQT", "CFP"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_transcribe_matches_jax(name, spec, tmp_path):
    jax_kw, jax_loads = FAMILIES[name]
    port = get_model(name, spec=spec, device="cpu", seed=0)
    n_bins = {"CQT": 176, "CFP": 386}[spec]
    assert port.n_bins == n_bins
    jmodel = jax_get_model(name, spec=spec, **jax_kw)
    template = _template(jmodel)
    if jax_loads:
        path = str(tmp_path / "weight.pt")
        torch.save(port.state_dict(), path)
        variables = jmodel.load_reference_weights(path, template)
    else:
        variables, report = torch_to_flax(_jax_names(port.state_dict()),
                                          template)
        assert report["skipped"] == []
    variables = _perturb(variables, 0)
    port.load_state_dict(flax_to_torch(variables, port), strict=True)

    audio = (np.random.RandomState(3).randn(1, FRAMES * 512) * 0.1).astype(
        np.float32)
    if name in ABLATION_ROLLS:
        def transcribe(v, a):
            spec, _ = jax_transcribe_spec(jmodel, a)
            onset, frame = ABLATION_ROLLS[name](
                jmodel.module.apply(v, spec, train=False))
            return {"onset": onset, "frame": frame}
    else:
        def transcribe(v, a):
            return jmodel.transcribe(v, a)
    ref = jax.jit(transcribe)(variables, jnp.asarray(audio))
    got = port.transcribe(torch.from_numpy(audio))
    frames = FRAMES - 2 if spec == "CFP" else FRAMES
    for roll in ("onset", "frame"):
        assert tuple(got[roll].shape) == (1, frames, 88), roll
        np.testing.assert_allclose(got[roll].numpy(), np.asarray(ref[roll]),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {spec} {roll}")


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_run_on_batch_refuses_cfp(name, monkeypatch):
    """Every model's `run_on_batch` raises ValueError for CFP before its
    frontend runs, naming the spectrogram's T - 2 frames and the labels'
    T."""
    model = get_model(name, spec="CFP", device="cpu")
    monkeypatch.setattr(model.frontend, "forward", lambda x: pytest.fail(
        "the frontend ran before the refusal"))
    rng = np.random.RandomState(0)
    batch = {"audio": torch.from_numpy(rng.randn(1, 40 * 512).astype(
                 np.float32) * 0.1),
             "frame": torch.zeros((1, 40, 88)),
             "onset": torch.zeros((1, 40, 88))}
    with pytest.raises(ValueError, match=r"T - 2 = 38 .* T = 40"):
        model.run_on_batch(batch, None, torch.Generator(), vat=False,
                           train=False)
