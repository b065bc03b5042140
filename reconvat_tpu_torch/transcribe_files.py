"""Transcribe the audio files of a folder to MIDI (the port's counterpart of
`transcribe_files.py`, reference `transcribe_files.py`):

    python -m reconvat_tpu_torch.transcribe_files with device=cpu \
        weight_path=<weights .pt> input_path=Application/Input \
        output_path=Application/Output

Reads the .flac and .wav files (16 kHz) of `input_path`, loads a torch
`.pt` of the reference's state_dict names (or a `model-N` checkpoint of
the port's training CLIs) into the port's ReconVAT (`model_type=ReconVAT`)
or SemanticSegmentation (`model_type=baseline_Multi_Inst`) on the frontend
`spec` ('Mel', 'CQT' or 'CFP'),
transcribes each song in fp32 (bucketed to `bucket_frames`, exact with 0,
or in haloed windows with `streaming=True` for hour-long recordings, Mel
only),
decodes notes with the native decoder and writes one MIDI file per song to
`output_path`. Runs on CUDA unless `device=cpu`; without a card it raises.
"""
import os

import numpy as np
import torch

from . import constants as C
from . import decode
from .config import Experiment
from .data.datasets import ApplicationDataset
from .data.midi_io import midi_to_hz, save_midi



def check_settings(cfg):
    """Raise, before any work, for streaming with a frontend other than
    Mel (`models/common.transcribe_streaming`, ROADMAP §1 item 1)."""
    if cfg["streaming"] and cfg["spec"] != "Mel":
        raise NotImplementedError(
            f"streaming=True with spec={cfg['spec']!r} is not ported "
            f"(ROADMAP §1 item 1): the streaming pass 1 reaches the Mel "
            f"window's 4 frames only")


ex = Experiment("transcription", check=check_settings)

log = True
mode = "imagewise"


def transcribe2midi(data, model, model_type, onset_threshold=0.5,
                    frame_threshold=0.5, save_path=None, rule="rule2",
                    bucket_frames=0, streaming=False,
                    streaming_windows=1, streaming_depth=3):
    """Reference `transcribe2midi` (`transcribe_files.py:12-40`). Returns,
    per song, (MIDI path, its (T, 88) frame posteriogram on the host)."""
    os.makedirs(save_path, exist_ok=True)
    written = []
    for item in data:
        audio = torch.from_numpy(item["audio"])[None].to(model.device)
        if streaming:
            pred = model.transcribe_streaming(
                audio, windows_per_batch=streaming_windows,
                pipeline_depth=streaming_depth)
        else:
            pred = model.transcribe(audio, bucket_frames=bucket_frames)
        onsets = np.maximum(pred["onset"][0].cpu().numpy(), 0)
        frames = np.maximum(pred["frame"][0].cpu().numpy(), 0)

        p_est, i_est = decode.extract_notes_wo_velocity(
            onsets, frames, onset_threshold, frame_threshold, rule=rule)

        scaling = C.HOP_LENGTH / C.SAMPLE_RATE
        i_est = (np.asarray(i_est) * scaling).reshape(-1, 2)
        p_est = np.array([midi_to_hz(C.MIN_MIDI + m) for m in p_est])

        # the reference's name: "<model_type>-<basename minus 4 chars>mid"
        name = os.path.basename(item["path"])[:-4]
        midi_path = os.path.join(save_path, f"{model_type}-{name}mid")
        print(f"midi_path = {midi_path}")
        save_midi(midi_path, p_est, i_est, [127] * len(p_est))
        written.append((midi_path, frames))
    return written


@ex.config
def config():
    device = "cuda"
    model_type = "ReconVAT"
    spec = "Mel"  # the frontend: 'Mel', 'CQT' or 'CFP'
    # torch .pt of the reference's names, or a model-N checkpoint directory
    # of the port's training CLI; None = the default
    weight_path = None
    # pad songs to this frame multiple (0 = exact per-song shapes,
    # reference-identical)
    bucket_frames = 512
    # streaming=True: bounded-memory haloed-window transcription for
    # hour-scale inputs (models/common.transcribe_streaming);
    # streaming_windows = windows stacked per forward when streaming
    streaming = False
    streaming_windows = 1
    # window forwards kept in flight with async D2H while streaming
    streaming_depth = 3
    # reference hardcodes Application/{Input,Output}
    # (`transcribe_files.py:47-48`); same defaults, overridable here
    input_path = os.path.join("Application", "Input")
    output_path = os.path.join("Application", "Output")


@ex.automain
def main(device, model_type, spec, weight_path, bucket_frames, streaming,
         streaming_windows, streaming_depth, input_path, output_path):
    # the model first: without a card this raises before any work
    if model_type == "ReconVAT":
        from .models.reconvat import ReconVAT

        model = ReconVAT(log=log, reconstruction=True, mode=mode, spec=spec,
                         seed=42, device=device)
        default_weight = ("Weight/String_MusicNet/"
                          "Unet_R_VAT-XI=1e-06-eps=1.3-String_MusicNet-"
                          "lr=0.001/weight.pt")
    elif model_type == "baseline_Multi_Inst":
        from .models.segmentation import SemanticSegmentation

        model = SemanticSegmentation(spec=spec, seed=42, device=device)
        default_weight = "Weight/String_MusicNet/baseline_Multi_Inst/weight.pt"
    else:
        raise ValueError(f"unknown model_type {model_type}")
    wpath = weight_path or default_weight

    application_dataset = ApplicationDataset(input_path)
    if os.path.exists(wpath):
        print("Loading model weight")
        if os.path.isdir(wpath):
            from .train.checkpoint import load_state

            # a model-N directory of the training CLI
            model.load_reference_weights(load_state(wpath)["model"])
        else:
            model.load_reference_weights(wpath)
        print("Loading done")
    else:
        print(f"WARNING: weight file {wpath!r} not found — "
              f"running with random weights (smoke mode)")

    print("Transcribing Music")
    return transcribe2midi(application_dataset, model, model_type,
                           save_path=output_path, bucket_frames=bucket_frames,
                           streaming=streaming,
                           streaming_windows=streaming_windows,
                           streaming_depth=streaming_depth)
