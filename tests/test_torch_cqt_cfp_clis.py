"""The port's CLIs on the CQT and CFP frontends, on the CPU.

- The training CLI (`train_UNet_VAT`) trains ReconVAT on CQT end to end on
  synthetic corpora (`tests/synth_data.py`; 40-frame crops, as CQT's
  16,384-sample reflect pad needs more than 32 frames), and the
  evaluation CLI evaluates its checkpoint with `spec=CQT`.
- Every training CLI refuses CFP, whose spec has T - 2 frames for labels
  of T, before the run directory is written.
- The transcription CLI writes a MIDI file per clip of `Application/Input`
  with `spec=CQT` and `spec=CFP` (random seeded weights), and refuses
  streaming on either before any work.
Nothing here compares numbers with the JAX package: the frontends and the
models on them are held to it in tests/test_torch_cqt_cfp.py and
tests/test_torch_cqt_cfp_models.py.
"""
import os
import pickle

import pytest

from reconvat_tpu_torch import evaluate_cli
from reconvat_tpu_torch import train_baseline_Multi_Inst as multi_cli
from reconvat_tpu_torch import train_baseline_onset_frame_VAT as of_cli
from reconvat_tpu_torch import train_baseline_Prestack as prestack_cli
from reconvat_tpu_torch import train_baseline_Thickstun as thickstun_cli
from reconvat_tpu_torch import train_UNet_Onset_VAT as onset_cli
from reconvat_tpu_torch import train_UNet_VAT as unet_cli
from reconvat_tpu_torch import transcribe_files

from . import synth_data
from .torch_threads import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT = os.path.join(ROOT, "Application", "Input")
TRAINING_CLIS = {"UNet_VAT": unet_cli, "UNet_Onset_VAT": onset_cli,
                 "onset_frame_VAT": of_cli, "Thickstun": thickstun_cli,
                 "Prestack": prestack_cli, "Multi_Inst": multi_cli}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """MAPS (4 AkPnBcht songs, for supersmall; one 2-s test song in each
    test group) and MAESTRO (1 song) under a temporary root, named by the
    RECONVAT_*_ROOT variables."""
    root = tmp_path_factory.mktemp("corpora")
    maps = str(root / "MAPS")
    synth_data.make_maps_like(maps, groups=("AkPnBcht",), files_per_group=4,
                              duration_s=3.0)
    for i, group in enumerate(("ENSTDkAm", "ENSTDkCl")):
        synth_data.make_maps_like(maps, groups=(group,), duration_s=2.0,
                                  seed=60 + i)
    synth_data.make_maestro_like(str(root / "MAESTRO"), n_files=1,
                                 duration_s=3.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RECONVAT_MAPS_ROOT", maps)
        mp.setenv("RECONVAT_MAESTRO_ROOT", str(root / "MAESTRO"))
        yield root


def test_training_and_evaluation_clis_take_cqt(corpus):
    """One epoch of the flagship's training CLI with spec=CQT writes its
    checkpoint and results; the evaluation CLI scores that checkpoint
    with spec=CQT."""
    model, _, metrics = unet_cli.ex.run(unet_cli.train, dict(
        device="cpu", spec="CQT", train_on="MAPS", small=True,
        sequence_length=40 * 512, batch_size=1, train_batch_size=1,
        iteration=1, epoches=1, saving_freq=1, logging_freq=1,
        compute_dtype=None, root=str(corpus / "runs")))
    assert model.n_bins == 176
    logdir = unet_cli.ex.current_run.config["logdir"]
    assert {"model-1", "result_dict"} <= set(os.listdir(logdir))
    assert any(k.startswith("metric/") for k in metrics)

    out = corpus / "results"
    evaluate_cli.ex.run(evaluate_cli.main, dict(
        device="cpu", spec="CQT", weight_file=os.path.join(logdir, "model-1"),
        output_folder=str(out)))
    logdir = evaluate_cli.ex.current_run.config["logdir"]
    with open(os.path.join(logdir, "result_dict_infer"), "rb") as f:
        assert any(k.startswith("metric/") for k in pickle.load(f))


@pytest.mark.parametrize("name", list(TRAINING_CLIS))
def test_training_clis_refuse_cfp_before_any_work(name, tmp_path):
    cli = TRAINING_CLIS[name]
    with pytest.raises(ValueError, match="T - 2"):
        cli.ex.run(cli.train, {"root": str(tmp_path), "device": "cpu",
                               "train_on": "nowhere", "spec": "CFP"})
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("spec", ["CQT", "CFP"])
def test_transcription_cli_writes_midi(spec, tmp_path):
    written = transcribe_files.ex.run(transcribe_files.main, dict(
        device="cpu", spec=spec, weight_path=str(tmp_path / "none.pt"),
        input_path=INPUT, output_path=str(tmp_path / "out")))
    assert sorted(os.listdir(tmp_path / "out")) == [
        "ReconVAT-clip_amid", "ReconVAT-clip_bmid"]
    # 8-s clips: 250 frames, bucketed to 512 and trimmed back
    assert [roll.shape for _, roll in written] == [(250, 88)] * 2


@pytest.mark.parametrize("spec", ["CQT", "CFP"])
def test_transcription_cli_refuses_streaming(spec, tmp_path):
    with pytest.raises(NotImplementedError, match="item 1\\)"):
        transcribe_files.ex.run(transcribe_files.main, dict(
            device="cpu", spec=spec, streaming=True, input_path=INPUT,
            output_path=str(tmp_path / "out")))
    assert not (tmp_path / "out").exists()
