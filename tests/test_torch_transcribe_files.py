"""The port's transcription CLI (`reconvat_tpu_torch/transcribe_files.py`)
and its host modules (audio and MIDI I/O, the input folder, the
`with key=value` config, reference-weight loading) against the JAX
package's, on the CPU.

End to end, both CLIs' `transcribe2midi` run the two clips of
`Application/Input` from one `.pt` written by `flax_to_torch` (perturbed
weights, the output bias shifted so that a few percent of bins are
active, as the serving tests do) and must write the same file names with
the same bytes. The posteriograms are held to atol 1e-4
(tests/test_torch_reconvat.py); where JAX's has an element within 1e-4 of
0.5, a bit may flip, so the notes of those pitches are set aside and the
other pitches' notes compared.
"""
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

import transcribe_files as jax_cli
from reconvat_tpu import config as jconfig
from reconvat_tpu.data import audio_io as jaudio
from reconvat_tpu.data import datasets as jdatasets
from reconvat_tpu.data import midi_io as jmidi
from reconvat_tpu.models.reconvat import ReconVAT as JaxReconVAT
from reconvat_tpu_torch import config, decode
from reconvat_tpu_torch import transcribe_files as cli
from reconvat_tpu_torch.data import audio_io, datasets, midi_io
from reconvat_tpu_torch.models.reconvat import ReconVAT
from reconvat_tpu_torch.weights import flax_to_torch

from . import flac_encoder
from .test_torch_bf16 import _jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT = os.path.join(ROOT, "Application", "Input")
ATOL = 1e-4
MODES = {"bucketed": dict(bucket_frames=512), "exact": dict(bucket_frames=0),
         "streaming": dict(streaming=True)}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX model, template variables, path of the shared .pt)."""
    jmodel = JaxReconVAT(log=True, reconstruction=True, mode="imagewise",
                         spec="Mel")
    port = ReconVAT(device="cpu")
    template = _jax_variables(port, lambda: jmodel.init(
        jax.random.PRNGKey(0), seq_frames=64), 0)
    port.load_state_dict(flax_to_torch(template), strict=True)
    audio = datasets.ApplicationDataset(INPUT)[0]["audio"]
    probs = port.transcribe(torch.from_numpy(audio)[None], 512)["frame"]
    q = float(np.quantile(probs.numpy(), 0.97))
    shift = np.float32(np.log(q / (1 - q)))
    params = dict(template["params"])
    transcriber = dict(params["transcriber"])
    transcriber["linear1"] = dict(
        transcriber["linear1"], bias=transcriber["linear1"]["bias"] - shift)
    params["transcriber"] = transcriber
    pt = str(tmp_path_factory.mktemp("weights") / "weight.pt")
    torch.save(flax_to_torch({**template, "params": params}), pt)
    return jmodel, template, pt


@pytest.fixture(scope="module")
def jax_runs(weights, tmp_path_factory):
    """Per mode: the JAX CLI's MIDI paths and posteriograms of both clips."""
    jmodel, template, pt = weights
    variables = jmodel.load_reference_weights(pt, template)
    data = jdatasets.ApplicationDataset(INPUT)
    runs = {}
    for mode, kw in MODES.items():
        out = str(tmp_path_factory.mktemp(f"jax_{mode}"))
        paths = jax_cli.transcribe2midi(data, jmodel, variables, "ReconVAT",
                                        save_path=out, **kw)
        rolls = []
        for item in data:
            audio = jnp.asarray(item["audio"])[None]
            pred = (jmodel.transcribe_streaming(variables, audio)
                    if kw.get("streaming")
                    else jmodel.transcribe(variables, audio,
                                           bucket_frames=kw["bucket_frames"]))
            rolls.append(np.asarray(pred["frame"])[0])
        runs[mode] = list(zip(paths, rolls))
    return runs


def _same_midi(jax_path, port_path, jax_roll):
    """The module docstring's rule; returns the pitches set aside."""
    assert os.path.basename(jax_path) == os.path.basename(port_path)
    near = np.flatnonzero((np.abs(jax_roll - 0.5) < ATOL).any(axis=0))
    if len(near) == 0:
        assert filecmp.cmp(jax_path, port_path, shallow=False), port_path
        return near
    ref, got = jmidi.parse_midi(jax_path), jmidi.parse_midi(port_path)
    keep = [~np.isin(np.asarray(n).reshape(-1, 4)[:, 2], near + 21)
            for n in (ref, got)]
    np.testing.assert_array_equal(np.asarray(got).reshape(-1, 4)[keep[1]],
                                  np.asarray(ref).reshape(-1, 4)[keep[0]])
    return near


@pytest.mark.parametrize("mode", list(MODES))
def test_transcribe2midi_matches_jax(weights, jax_runs, mode, tmp_path):
    """Same file names (`ReconVAT-clip_amid`), same bytes, same
    posteriograms; the native decoder decodes every clip."""
    model = ReconVAT(device="cpu")
    model.load_reference_weights(weights[2])
    calls = decode.extract_notes_wo_velocity.calls
    written = cli.transcribe2midi(datasets.ApplicationDataset(INPUT), model,
                                  "ReconVAT", save_path=str(tmp_path),
                                  **MODES[mode])
    assert decode.extract_notes_wo_velocity.calls == calls + 2
    assert [os.path.basename(p) for p, _ in written] == [
        "ReconVAT-clip_amid", "ReconVAT-clip_bmid"]
    set_aside, notes = 0, 0
    for (jpath, jroll), (ppath, proll) in zip(jax_runs[mode], written):
        assert proll.shape == jroll.shape == (250, 88)
        np.testing.assert_allclose(proll, jroll, atol=ATOL)
        set_aside += len(_same_midi(jpath, ppath, jroll))
        notes += len(jmidi.parse_midi(ppath))
    print(f"{mode}: {notes} notes, {set_aside} of 176 pitches set aside "
          f"(a JAX posteriogram element within {ATOL} of 0.5)")
    assert notes > 0 and set_aside <= 176 // 4


def test_cli_subprocess_on_cpu(weights, jax_runs, tmp_path):
    """`python -m reconvat_tpu_torch.transcribe_files with device=cpu ...`
    writes the JAX CLI's files at its default bucket."""
    proc = subprocess.run(
        [sys.executable, "-m", "reconvat_tpu_torch.transcribe_files", "with",
         "device=cpu", f"weight_path={weights[2]}", f"input_path={INPUT}",
         f"output_path={tmp_path}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Loading done" in proc.stdout
    assert sorted(os.listdir(tmp_path)) == ["ReconVAT-clip_amid",
                                            "ReconVAT-clip_bmid"]
    for jpath, jroll in jax_runs["bucketed"]:
        _same_midi(jpath, str(tmp_path / os.path.basename(jpath)), jroll)


def test_cli_config_and_limits(tmp_path, capsys):
    """The `with key=value` parse and the resolved config equal the JAX
    CLI's (device defaults to cuda in the port); what the port does not
    run raises with its ROADMAP item."""
    argv = ["print_config", "with", "bucket_frames=0", "streaming=True",
            "input_path=some/dir", "weight_path=w.pt", "note=a b"]
    assert config.parse_cli(argv) == jconfig.parse_cli(argv)
    _, overrides = config.parse_cli(argv)
    got = cli.ex._resolve(overrides)
    ref = jax_cli.ex._resolve(overrides)
    assert got.pop("device") == "cuda" and ref.pop("device") == "tpu"
    assert got == ref
    assert cli.ex.run(cli.main, overrides, ["print_config"]) is None
    assert "bucket_frames = 0" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.ex.run(cli.main, {"model_type": "baseline_Multi_Inst",
                              "device": "cpu"})
    # a directory that is not a checkpoint of the port (an orbax one of
    # the JAX package holds no state.pt) raises naming the reason
    with pytest.raises(ValueError, match="orbax"):
        cli.ex.run(cli.main, {"weight_path": str(tmp_path), "device": "cpu"})


def test_load_reference_weights(weights, tmp_path):
    """The reference's extra entries load; an unknown or a missing key
    raises and leaves the weights as they were; a saved module loads."""
    sd = torch.load(weights[2], weights_only=False)
    extra = dict(sd, **{"spectrogram.mel_basis": torch.zeros(3),
                        "normalize.x": torch.zeros(1),
                        "vat_loss.xi": torch.zeros(1)})
    torch.save(extra, tmp_path / "extra.pt")
    model = ReconVAT(device="cpu")
    model.load_reference_weights(str(tmp_path / "extra.pt"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    before = {k: v.clone() for k, v in ReconVAT(device="cpu").state_dict()
              .items()}
    for name, bad in (("unknown", dict(sd, **{"lstm9.w": torch.zeros(1)})),
                      ("missing", {k: v for k, v in sd.items()
                                   if k != "transcriber.linear1.bias"})):
        torch.save(bad, tmp_path / f"{name}.pt")
        fresh = ReconVAT(device="cpu")
        with pytest.raises(ValueError, match="lstm9.w|linear1.bias"):
            fresh.load_reference_weights(str(tmp_path / f"{name}.pt"))
        assert all(torch.equal(v, before[k])
                   for k, v in fresh.state_dict().items())
    torch.save(model, tmp_path / "module.pt")
    again = ReconVAT(device="cpu")
    again.load_reference_weights(str(tmp_path / "module.pt"))
    assert torch.equal(again.transcriber.linear1.bias,
                       sd["transcriber.linear1.bias"])


def _write_audio(path, kind):
    rng = np.random.RandomState(len(kind))
    x = (rng.randn(4000) * 3000).clip(-32768, 32767)
    if kind == "flac_mono":
        with open(path, "wb") as f:
            f.write(flac_encoder.encode_flac(x.astype(np.int16), 16000))
    elif kind == "flac_stereo":
        st = np.stack([x, x[::-1] * 0.5], 1).astype(np.int16)
        with open(path, "wb") as f:
            f.write(flac_encoder.encode_flac(st, 16000,
                                             stereo_mode="mid_side"))
    else:
        data = {"int16": x.astype(np.int16),
                "int32": (x * 65536).astype(np.int32),
                "float32": (x / 32768).astype(np.float32),
                "uint8": (x / 256 + 128).clip(0, 255).astype(np.uint8),
                "stereo": np.stack([x, -x], 1).astype(np.int16)}[kind]
        wavfile.write(path, 16000, data)


@pytest.mark.parametrize("kind", ["int16", "int32", "float32", "uint8",
                                  "stereo", "flac_mono", "flac_stereo"])
def test_read_audio_matches_jax(kind, tmp_path):
    path = str(tmp_path / ("a.flac" if kind.startswith("flac") else "a.wav"))
    _write_audio(path, kind)
    pcm, sr = audio_io.read_audio(path)
    ref_pcm, ref_sr = jaudio.read_audio(path)
    assert pcm.dtype == ref_pcm.dtype == np.int16 and sr == ref_sr == 16000
    np.testing.assert_array_equal(pcm, ref_pcm)
    with pytest.raises(ValueError):
        audio_io.read_audio(str(tmp_path / "a.mp3"))


def test_application_dataset_matches_jax(tmp_path):
    for kind, name in (("int16", "b.wav"), ("flac_mono", "a.flac"),
                       ("flac_stereo", "c.flac")):
        _write_audio(str(tmp_path / name), kind)
    for folder in (INPUT, str(tmp_path)):
        got, ref = (datasets.ApplicationDataset(folder),
                    jdatasets.ApplicationDataset(folder))
        assert len(got) == len(ref) > 0
        for i in range(len(ref)):
            assert got[i]["path"] == ref[i]["path"]
            assert got[i]["audio"].dtype == np.float32
            np.testing.assert_array_equal(got[i]["audio"], ref[i]["audio"])
    wavfile.write(str(tmp_path / "d.wav"), 22050, np.zeros(100, np.int16))
    with pytest.raises(ValueError, match="16k"):
        datasets.ApplicationDataset(str(tmp_path))


@pytest.mark.parametrize("velocity", ["cli", "fractional", "empty"])
def test_save_midi_matches_jax(velocity, tmp_path):
    rng = np.random.RandomState(5)
    n = 0 if velocity == "empty" else 40
    pitches = midi_io.midi_to_hz(21 + rng.randint(0, 88, n))
    onsets = rng.randint(0, 250, n) * 512 / 16000
    intervals = np.stack([onsets, onsets + rng.randint(1, 40, n) * 0.032], 1)
    vel = [127] * n if velocity == "cli" else list(rng.rand(n))
    midi_io.save_midi(str(tmp_path / "p.mid"), pitches, intervals, vel)
    jmidi.save_midi(str(tmp_path / "j.mid"), pitches, intervals, vel)
    assert filecmp.cmp(tmp_path / "p.mid", tmp_path / "j.mid", shallow=False)
    np.testing.assert_array_equal(midi_io.hz_to_midi(pitches),
                                  jmidi.hz_to_midi(pitches))
