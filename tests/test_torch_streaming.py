"""The port's streaming transcription (`ReconVAT.transcribe_streaming`,
`models/common.transcribe_streaming`) against the JAX package's and
against its own one-shot `transcribe`, on the CPU, full width, with the
JAX weights carried over by `flax_to_torch`.

Tolerances:
- against JAX at the same windows: atol 1e-4, the posteriogram tolerance
  of tests/test_torch_reconvat.py (fp32 on both sides, other summation
  orders);
- against the port's own bucketed path: interior atol 1e-5 and the last 64
  frames 1e-3, the bounds of the JAX package's own test
  (tests/test_streaming_transcribe.py:41-42): the last window pads past
  the song end like the bucketed path, reflect and then zeros, but the
  two reflect over other lengths;
- `pipeline_depth` changes scheduling only: identical output;
- `windows_per_batch` stacks windows into one forward: atol 1e-5, as JAX's
  test (other batch sizes may take other convolution algorithms).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu import constants as JC
from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_bf16 import _jax_variables
from .torch_threads import torch_one_thread  # noqa: F401

ATOL = 1e-4


def _song(seconds, B=1, seed=0):
    """(B, N) tones with a slow envelope and a little noise; each further
    batch row 26 dB quieter than the one before (imagewise statistics are
    per row)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * JC.SAMPLE_RATE)) / JC.SAMPLE_RATE
    rows = []
    for b in range(B):
        sig = sum(0.2 * np.sin(2 * np.pi * f * t + rng.rand())
                  for f in (220.0, 440.0, 523.25, 660.0))
        sig = sig * (0.5 + 0.5 * np.sin(2 * np.pi * 0.3 * t))
        rows.append((sig + 0.01 * rng.randn(len(t))) * 0.05 ** b)
    return np.stack(rows).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxReconVAT(conv_layout="nhwc")
    port = ReconVAT(device="cpu")
    variables = _jax_variables(port, lambda: jmodel.init(
        jax.random.PRNGKey(0), seq_frames=64), 0)
    port.load_state_dict(flax_to_torch(variables), strict=True)
    return jmodel, variables, port


def test_streaming_matches_jax(models):
    """Same W = 64, H = 32 windows, two rows 26 dB apart, 4 windows."""
    jmodel, variables, port = models
    audio = _song(200 * 512 / 16000, B=2, seed=1)     # 200 frames
    ref = np.asarray(jmodel.transcribe_streaming(
        variables, jnp.asarray(audio), window_frames=64,
        halo_frames=32)["frame"])
    got = port.transcribe_streaming(torch.from_numpy(audio),
                                    window_frames=64, halo_frames=32)
    assert got["onset"] is got["frame"]
    assert got["frame"].device.type == "cpu"
    assert tuple(got["frame"].shape) == ref.shape == (2, 200, 88)
    np.testing.assert_allclose(got["frame"].numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("mode", ["imagewise", "framewise"])
def test_streaming_matches_bucketed(models, mode):
    """W = H = 128 over 800 frames (7 windows) against the bucketed
    `transcribe` of the whole song (bucket 512, the CLI's default)."""
    port = models[2]
    model = port
    if mode != "imagewise":
        model = ReconVAT(device="cpu", mode=mode)
        model.load_state_dict(port.state_dict())
    audio = torch.from_numpy(_song(800 * 512 / 16000, seed=2))
    full = model.transcribe(audio, bucket_frames=512)["frame"].numpy()
    streamed = model.transcribe_streaming(audio, window_frames=128,
                                          halo_frames=128)["frame"].numpy()
    assert streamed.shape == full.shape == (1, 800, 88)
    np.testing.assert_allclose(streamed[:, :-64], full[:, :-64], atol=1e-5)
    np.testing.assert_allclose(streamed[:, -64:], full[:, -64:], atol=1e-3)


def test_pipeline_depth_identical_and_window_batching(models):
    port = models[2]
    audio = torch.from_numpy(_song(300 * 512 / 16000, seed=3))   # 5 windows

    def run(**kw):
        return port.transcribe_streaming(audio, window_frames=64,
                                         halo_frames=32, **kw)["frame"]

    d1 = run(pipeline_depth=1)
    np.testing.assert_array_equal(run(pipeline_depth=3).numpy(), d1.numpy())
    g2 = run(windows_per_batch=2)        # the last group holds a copy
    np.testing.assert_allclose(g2.numpy(), d1.numpy(), atol=1e-5)
    np.testing.assert_array_equal(
        run(windows_per_batch=2, pipeline_depth=1).numpy(), g2.numpy())


def test_short_clip_is_one_bucketed_call(models):
    """A song of at most W + 2H frames is the bucketed transcribe padded to
    that span, the same computation (the clips of
    tests/test_torch_transcribe_files.py take this branch against JAX's)."""
    port = models[2]
    audio = torch.from_numpy(_song(6.0, seed=4))          # 188 frames
    streamed = port.transcribe_streaming(audio, window_frames=128,
                                         halo_frames=64)["frame"]
    bucketed = port.transcribe(audio, bucket_frames=256)["frame"]
    assert tuple(streamed.shape) == (1, 188, 88)
    np.testing.assert_array_equal(streamed.numpy(), bucketed.numpy())


def test_streaming_rejects_what_is_not_ported_or_misaligned(models):
    port = models[2]
    audio = torch.zeros(1, 64 * 512)
    with pytest.raises(NotImplementedError, match="item 3.2"):
        port.transcribe_streaming(audio, mesh_ctx=object())
    with pytest.raises(ValueError, match="multiples of 16"):
        port.transcribe_streaming(audio, window_frames=100)
    with pytest.raises(ValueError, match="halo"):
        port.transcribe_streaming(audio, halo_frames=0)


def test_fp32_math_keeps_cudnn_determinism():
    """The serving and streaming calls' fp32 context keeps the caller's
    cuDNN determinism (the card's bit-identity check of pipeline depths
    turns it on) and restores TF32 on exit."""
    from reconvat_tpu_torch.models.reconvat import fp32_math

    cudnn = torch.backends.cudnn
    det, tf32 = cudnn.deterministic, cudnn.allow_tf32
    try:
        cudnn.deterministic, cudnn.allow_tf32 = True, True
        with fp32_math():
            assert cudnn.deterministic and not cudnn.allow_tf32
        assert cudnn.deterministic and cudnn.allow_tf32
    finally:
        cudnn.deterministic, cudnn.allow_tf32 = det, tf32
