"""Port's U-Net, full ReconVAT forward and transcribe vs the JAX package,
on the CPU, with the JAX weights carried over by `flax_to_torch`.

Tolerances:
- encoder/decoder activations and the reconstruction: atol 1e-4 (rtol
  1e-4); both sides are fp32, and only the convolution and BatchNorm
  summation orders differ (oneDNN vs XLA:CPU) over up to 192 x 9 terms.
- posteriograms and attention: atol 1e-4, set by the normalized log-spec
  input (see tests/test_torch_frontend.py) and the fp32 U-Net above.
- packed rolls on the serving path: identical wherever the JAX
  posteriogram is at least 1e-4 away from the 0.5 threshold.
The JAX model runs its default (XLA, NHWC) path; BatchNorm is in eval mode
with random running statistics so that it is not the identity.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reconvat_tpu import decode as jdecode
from reconvat_tpu.models.common import pack_roll_device as jax_pack
from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu.nn.unet import Decoder as JaxDecoder
from reconvat_tpu.nn.unet import Encoder as JaxEncoder
from reconvat_tpu.train.torch_convert import torch_to_flax
from reconvat_tpu_torch import serve
from reconvat_tpu_torch.decode import unpack_roll
from reconvat_tpu_torch.models.reconvat import ReconVAT, resolve_device
from reconvat_tpu_torch.nn.unet import Decoder, Encoder
from reconvat_tpu_torch.weights import flax_to_torch

from .torch_threads import torch_one_thread  # noqa: F401

ATOL, RTOL = 1e-4, 1e-4


def _perturb(variables, seed=0):
    """Random biases / BN statistics on top of the init, so that every
    leaf's layout is exercised (init biases are zero, BN the identity)."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v, np.float32)
            if k == "var":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                v = v + 0.05 * rng.randn(*v.shape).astype(np.float32)
            elif k == "scale":
                v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            out[k] = v
        return out

    return {k: walk(v) for k, v in variables.items()}


@pytest.fixture(scope="module")
def jax_model():
    model = JaxReconVAT(conv_layout="nhwc")
    variables = _perturb(model.init(jax.random.PRNGKey(0), seq_frames=64))
    return model, variables


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, variables = jax_model
    model = ReconVAT(device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model


def _audio(B, n, seed):
    return (np.random.RandomState(seed).randn(B, n) * 0.1).astype(np.float32)


def test_encoder_decoder_match_jax():
    x = np.random.RandomState(1).rand(2, 32, 40, 1).astype(np.float32)
    enc, dec = JaxEncoder(layout="nhwc"), JaxDecoder(layout="nhwc")
    ve = _perturb(enc.init(jax.random.PRNGKey(1), jnp.asarray(x), False), 1)
    z, s, c = enc.apply(ve, jnp.asarray(x), False)
    vd = _perturb(dec.init(jax.random.PRNGKey(2), z, s, c, False), 2)
    y = dec.apply(vd, z, s, c, False)

    tenc, tdec = Encoder().eval(), Decoder().eval()
    tenc.load_state_dict(flax_to_torch(ve), strict=True)
    tdec.load_state_dict(flax_to_torch(vd), strict=True)
    with torch.no_grad():
        tz, ts, tc = tenc(torch.from_numpy(x).permute(0, 3, 1, 2))
        ty = tdec(tz, ts, tc)
    assert ts == [tuple(v) for v in s]
    np.testing.assert_allclose(tz.permute(0, 2, 3, 1).numpy(), np.asarray(z),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(tc, c):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).numpy(), np.asarray(y),
                               rtol=RTOL, atol=ATOL)


def test_full_forward_matches_jax(jax_model, port_model):
    """UNet forward with reconstruction: every parameter is used."""
    model, variables = jax_model
    x = np.random.RandomState(2).rand(1, 64, 229, 1).astype(np.float32)
    ref = model.module.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_model(torch.from_numpy(x))
    for name, a, b in zip(("reconstruction", "pianoroll", "pianoroll2",
                           "attention"), got, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("n,bucket", [(64 * 512, 0), (512 * 50 + 7, 64)])
def test_transcribe_matches_jax(jax_model, port_model, n, bucket):
    model, variables = jax_model
    audio = _audio(2, n, seed=3)
    ref = model.transcribe(variables, jnp.asarray(audio), bucket)["frame"]
    got = port_model.transcribe(torch.from_numpy(audio), bucket)
    assert got["onset"] is got["frame"]
    assert tuple(got["frame"].shape) == ref.shape
    np.testing.assert_allclose(got["frame"].numpy(), np.asarray(ref),
                               atol=ATOL)


def test_serving_path_matches_jax(jax_model, port_model):
    """int16 -> transcribe -> pack -> decode, both packages, same weights.
    Packed bits may differ only where the JAX posteriogram lies within the
    posteriogram tolerance of the 0.5 threshold."""
    jmodel, variables = jax_model
    model = ReconVAT(device="cpu")
    model.load_state_dict(port_model.state_dict())
    audio_i16 = (np.random.RandomState(4).randn(2, 64 * 512) * 3276.8
                 ).astype(np.int16)
    # shift the output bias so that ~2% of bins are active (as bench.py
    # calibrates it): logit of the 98th percentile of the posteriogram
    p0 = model.transcribe(torch.from_numpy(audio_i16 / 32768.0).float())
    q98 = float(np.quantile(p0["frame"].numpy(), 0.98))
    shift = np.float32(np.log(q98 / (1 - q98)))
    with torch.no_grad():
        model.transcriber.linear1.bias -= shift
    params = dict(variables["params"])
    transcriber = dict(params["transcriber"])
    transcriber["linear1"] = dict(transcriber["linear1"],
                                  bias=transcriber["linear1"]["bias"] - shift)
    params["transcriber"] = transcriber
    variables = {**variables, "params": params}

    probs = np.asarray(jmodel.transcribe(
        variables, jnp.asarray(audio_i16.astype(np.float32) / 32768.0)
    )["frame"])
    ref_packed = np.asarray(jax_pack(jnp.asarray(probs)))
    got_packed = serve.submit(model, audio_i16).packed().numpy()
    assert got_packed.shape == ref_packed.shape == (2, 64, 11)
    assert 0 < (probs > 0.5).mean() < 0.5
    sure = np.abs(probs - 0.5) >= ATOL
    np.testing.assert_array_equal(unpack_roll(got_packed)[sure],
                                  jdecode.unpack_roll(ref_packed)[sure])
    notes = serve.transcribe_batch(model, audio_i16)
    assert len(notes) == 2 and sum(len(p) for p, _ in notes) > 0
    assert all(len(p) == len(i) for p, i in notes)


def test_weights_round_trip(jax_model, port_model):
    """flax -> port state_dict -> the JAX package's torch_to_flax gives the
    same tree back, with nothing skipped."""
    _, variables = jax_model
    back, report = torch_to_flax(port_model.state_dict(), variables)
    assert report["skipped"] == []
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_seeded_init_is_deterministic():
    a = ReconVAT(device="cpu", seed=3).state_dict()
    b = ReconVAT(device="cpu", seed=3).state_dict()
    c = ReconVAT(device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["transcriber.linear1.weight"],
                           c["transcriber.linear1.weight"])


def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    """The model and the transcription CLI raise without a card unless the
    CPU is asked for, and the CLI writes nothing then."""
    from reconvat_tpu_torch import transcribe_files

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReconVAT()
    assert resolve_device("cpu") == torch.device("cpu")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transcribe_files.ex.run(transcribe_files.main,
                                {"output_path": str(out)})
    assert not out.exists()


PORT_MODULES = [
    "reconvat_tpu_torch", "reconvat_tpu_torch.constants",
    "reconvat_tpu_torch.decode", "reconvat_tpu_torch.serve",
    "reconvat_tpu_torch.weights", "reconvat_tpu_torch.kernels._build",
    "reconvat_tpu_torch.kernels.bwd_phases",
    "reconvat_tpu_torch.kernels.bwd_variants",
    "reconvat_tpu_torch.train.bf16_card_rule",
    "reconvat_tpu_torch.models.common", "reconvat_tpu_torch.models.reconvat",
    "reconvat_tpu_torch.models.losses", "reconvat_tpu_torch.vat",
    "reconvat_tpu_torch.train", "reconvat_tpu_torch.train.state",
    "reconvat_tpu_torch.nn.attention", "reconvat_tpu_torch.nn.precision",
    "reconvat_tpu_torch.nn.unet",
    "reconvat_tpu_torch.ops.filterbanks", "reconvat_tpu_torch.ops.mel_kernel",
    "reconvat_tpu_torch.ops.banded_attention_kernel",
    "reconvat_tpu_torch.ops.normalize", "reconvat_tpu_torch.ops.spectrogram",
    "reconvat_tpu_torch.config", "reconvat_tpu_torch.transcribe_files",
    "reconvat_tpu_torch.data", "reconvat_tpu_torch.data.audio_io",
    "reconvat_tpu_torch.data.midi_io", "reconvat_tpu_torch.data.datasets",
    "reconvat_tpu_torch.models.streaming_probe",
    "reconvat_tpu_torch.metrics", "reconvat_tpu_torch.utils",
    "reconvat_tpu_torch.evaluate", "reconvat_tpu_torch.data.labels",
    "reconvat_tpu_torch.data.loader", "reconvat_tpu_torch.train.prepare",
    "reconvat_tpu_torch.train.profiler", "reconvat_tpu_torch.train.checkpoint",
    "reconvat_tpu_torch.train.loop", "reconvat_tpu_torch.train.driver",
    "reconvat_tpu_torch.train_UNet_VAT",
    "reconvat_tpu_torch.models", "reconvat_tpu_torch.models.base",
    "reconvat_tpu_torch.models.unet_onset",
    "reconvat_tpu_torch.train_UNet_Onset_VAT",
    "reconvat_tpu_torch.evaluate_cli",
    "reconvat_tpu_torch.nn.layers", "reconvat_tpu_torch.models.onsets_frames",
    "reconvat_tpu_torch.models.thickstun",
    "reconvat_tpu_torch.models.prestack",
    "reconvat_tpu_torch.train_baseline_onset_frame_VAT",
    "reconvat_tpu_torch.train_baseline_Thickstun",
    "reconvat_tpu_torch.train_baseline_Prestack",
    "reconvat_tpu_torch.models.segmentation",
    "reconvat_tpu_torch.models.attention_models",
    "reconvat_tpu_torch.train_baseline_Multi_Inst",
    "reconvat_tpu_torch.parallel", "reconvat_tpu_torch.parallel.distributed",
    "reconvat_tpu_torch.parallel.mesh", "reconvat_tpu_torch.parallel.launch",
    "reconvat_tpu_torch.ops.extra_frontends",
    "reconvat_tpu_torch.preprocess_audio",
    "chip_smoke",
]


def test_port_imports_no_jax():
    """A fresh interpreter that imports every port module and chip_smoke.py
    holds neither jax nor any module of the JAX package."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'flax'))\n"
        "             or m == 'reconvat_tpu'\n"
        "             or m.startswith('reconvat_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
