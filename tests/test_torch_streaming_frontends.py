"""Streaming transcription on the CQT and CFP frontends
(`models/common.transcribe_streaming`), on the CPU, full width, with the
JAX package's weights carried over by `flax_to_torch`.

Pass 1 reduces the song-global statistics over chunks with an edge halo of
the frontend's reach plus its dropped frames (`frame_reach` +
`frame_offset`: CQT 32, CFP 5); a slice's spec frame i is the song's
frame f0 + i on both frontends (CFP drops the slice's first frame as it
drops the song's).

Tolerances:
- against the port's own bucketed `transcribe` (bucket 512, the CLI's
  default): interior atol 1e-5 and the last 64 frames 1e-3, the bounds of
  tests/test_torch_streaming.py for Mel;
- against the JAX package's bucketed `transcribe` on the same weights:
  atol 1e-4 inside, the posteriogram tolerance of
  tests/test_torch_cqt_cfp.py;
- depth 1 against depth 3: identical.
The JAX package's own stream keeps the Mel window's 4-frame pass-1 halo;
`test_jax_streaming_reading` prints its gap to its bucketed transcribe
(ROADMAP, "Known on the JAX side") and holds the port's stream nearer.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu_torch import transcribe_files
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.weights import flax_to_torch

from .test_torch_bf16 import _jax_variables
from .test_torch_streaming import _song
from .torch_threads import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT = os.path.join(ROOT, "Application", "Input")
W, H, FRAMES, TAIL = 64, 32, 300, 64


@pytest.fixture(scope="module", params=["CQT", "CFP"])
def streams(request):
    """(spec, port model, JAX bucketed roll, port bucketed roll, port
    stream at depth 3, the song) for one frontend."""
    spec = request.param
    jmodel = JaxReconVAT(conv_layout="nhwc", spec=spec)
    port = ReconVAT(device="cpu", spec=spec)
    variables = _jax_variables(port, lambda: jmodel.init(
        jax.random.PRNGKey(0), seq_frames=64), 0)
    port.load_state_dict(flax_to_torch(variables), strict=True)
    audio = _song(FRAMES * 512 / 16000, seed=2)
    jax_full = np.asarray(jmodel.transcribe(
        variables, jnp.asarray(audio), bucket_frames=512)["frame"])
    jax_stream = np.asarray(jmodel.transcribe_streaming(
        variables, jnp.asarray(audio), window_frames=W,
        halo_frames=H)["frame"])
    full = port.transcribe(torch.from_numpy(audio),
                           bucket_frames=512)["frame"].numpy()
    stream = port.transcribe_streaming(torch.from_numpy(audio),
                                       window_frames=W, halo_frames=H)
    return dict(spec=spec, port=port, jax_full=jax_full,
                jax_stream=jax_stream, full=full,
                stream=stream["frame"].numpy(), audio=audio)


def test_stream_matches_bucketed(streams):
    stream, full = streams["stream"], streams["full"]
    assert stream.shape == full.shape == (1, FRAMES, 88)
    np.testing.assert_allclose(stream[:, :-TAIL], full[:, :-TAIL],
                               atol=1e-5)
    np.testing.assert_allclose(stream[:, -TAIL:], full[:, -TAIL:],
                               atol=1e-3)


def test_stream_matches_jax_bucketed(streams):
    stream, jax_full = streams["stream"], streams["jax_full"]
    assert stream.shape == jax_full.shape
    np.testing.assert_allclose(stream[:, :-TAIL], jax_full[:, :-TAIL],
                               atol=1e-4)


def test_jax_streaming_reading(streams):
    """The JAX package's stream against its own bucketed transcribe (its
    pass 1 keeps a 4-frame halo; CQT's kernel reaches 32): printed, and
    the port's stream is no further from that bucketed roll."""
    jax_full = streams["jax_full"][:, :-TAIL]
    jax_gap = np.abs(streams["jax_stream"][:, :-TAIL] - jax_full).max()
    port_gap = np.abs(streams["stream"][:, :-TAIL] - jax_full).max()
    print(f"{streams['spec']}: JAX stream vs JAX bucketed {jax_gap}, "
          f"port stream vs JAX bucketed {port_gap} (W {W}, H {H}, "
          f"{FRAMES} frames)")
    assert port_gap <= max(jax_gap, 1e-5)


def test_depths_and_halo(streams):
    """Depth 1 equals depth 3; a halo below the frontend's reach raises,
    and so does a stream over devices (not ported)."""
    port, audio = streams["port"], torch.from_numpy(streams["audio"])
    d1 = port.transcribe_streaming(audio, window_frames=W, halo_frames=H,
                                   pipeline_depth=1)["frame"].numpy()
    np.testing.assert_array_equal(d1, streams["stream"])
    reach = port.frontend.frame_reach + port.frontend.frame_offset
    assert reach == {"CQT": 32, "CFP": 5}[streams["spec"]]
    if streams["spec"] == "CQT":
        with pytest.raises(ValueError, match="reaches 32 frames"):
            port.transcribe_streaming(audio, window_frames=W,
                                      halo_frames=16)
    with pytest.raises(NotImplementedError, match="item 3.2"):
        port.transcribe_streaming(audio, mesh_ctx=object())


@pytest.mark.parametrize("spec", ["CQT", "CFP"])
def test_transcription_cli_streams(spec, tmp_path):
    """The transcription CLI with `streaming=True` (its default windows;
    the 8-s clips are one bucketed call each) writes the MIDI files and
    the rolls of the bucketed CLI run within the tolerance."""
    args = dict(device="cpu", spec=spec, weight_path=str(tmp_path / "none"),
                input_path=INPUT)
    streamed = transcribe_files.ex.run(transcribe_files.main, dict(
        args, streaming=True, output_path=str(tmp_path / "streamed")))
    bucketed = transcribe_files.ex.run(transcribe_files.main, dict(
        args, output_path=str(tmp_path / "bucketed")))
    assert sorted(os.listdir(tmp_path / "streamed")) == [
        "ReconVAT-clip_amid", "ReconVAT-clip_bmid"]
    for (_, a), (_, b) in zip(streamed, bucketed):
        assert a.shape == b.shape == (250, 88)
        np.testing.assert_allclose(a[:-TAIL], b[:-TAIL], atol=1e-5)
        np.testing.assert_allclose(a, b, atol=1e-3)
