"""The port's remaining host modules against the JAX package's, on the
CPU: the Corelli and ApplicationWind datasets, `prepare_dataset`, velocity
decode (`extract_notes`) and `notes_to_frames`, the MIDI writers
(`write_midi_events`, `midi_files_to_tsv` and `python -m
reconvat_tpu_torch.data.midi_io`), `write_wav`, and the corpus staging CLI
(`python -m reconvat_tpu_torch.preprocess_audio` against
`tools/preprocess_audio.py`).

Tolerance: none. Each is numpy, scipy or plain Python on both sides, so
listings, crops, rolls, notes and velocities are equal (bit for bit) and
every file written is byte-equal. Each package reads its own copy of a
corpus (the datasets write a cache beside each audio file).
"""
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from reconvat_tpu import decode as jdecode
from reconvat_tpu.data import audio_io as jaudio_io
from reconvat_tpu.data import datasets as jdatasets
from reconvat_tpu.data import midi_io as jmidi_io
from reconvat_tpu.train import prepare as jprepare
from reconvat_tpu_torch import decode
from reconvat_tpu_torch.data import audio_io, datasets, midi_io
from reconvat_tpu_torch.data.labels import save_tsv
from reconvat_tpu_torch.train import prepare

from . import flac_encoder, synth_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEM_KEYS = ("audio", "onset", "offset", "frame", "velocity")


def _write_clip(path, seed=0, duration=2.0):
    """A synthetic clip (.flac or .wav by the name) and its label rows."""
    rows = synth_data.synth_notes(duration, seed=seed, n_notes=4)
    audio = synth_data.render_audio(rows, duration)
    if path.endswith(".flac"):
        with open(path, "wb") as f:
            f.write(flac_encoder.encode_flac(audio, 16000))
    else:
        audio_io.write_wav(path, audio, 16000)
    return rows


def _twins(tmp_path, build):
    """(the port's root, the JAX package's root): one corpus written by
    `build(root)`, copied before either package reads it."""
    port_root = str(tmp_path / "port")
    os.makedirs(port_root)
    build(port_root)
    shutil.copytree(port_root, str(tmp_path / "jax"))
    return port_root, str(tmp_path / "jax")


def _same_datasets(got, ref, got_root, ref_root):
    """Equal listings (paths relative to each root) and equal items."""
    assert type(got).__name__ == type(ref).__name__
    assert len(got) == len(ref) > 0
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        assert (os.path.relpath(a["path"], got_root)
                == os.path.relpath(b["path"], ref_root))
        assert a.get("start_idx") == b.get("start_idx")
        for k in ITEM_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _corelli(root):
    for g, group in enumerate(("op6_no1", "op6_no2")):
        os.makedirs(os.path.join(root, group))
        for i in range(2):
            name = os.path.join(root, group, f"mov{i}")
            save_tsv(name + ".tsv",
                     _write_clip(name + ".flac", seed=2 * g + i))
    # overlap=False leaves out the files named in overlapping.pkl
    with open(os.path.join(root, "overlapping.pkl"), "wb") as f:
        pickle.dump(["op6_no2/mov1"], f)


@pytest.mark.parametrize("kw", [dict(groups=["op6_no1"]),
                                dict(groups=["op6_no1", "op6_no2"],
                                     sequence_length=16 * 512),
                                dict(groups=["op6_no2"], overlap=False)])
def test_corelli_matches_jax(tmp_path, kw):
    port_root, jax_root = _twins(tmp_path, _corelli)
    got = datasets.Corelli(port_root, verbose=False, **kw)
    ref = jdatasets.Corelli(jax_root, verbose=False, **kw)
    _same_datasets(got, ref, port_root, jax_root)
    assert datasets.Corelli.available_groups() == \
        jdatasets.Corelli.available_groups()
    if kw.get("overlap") is False:
        assert [os.path.basename(d["path"]) for d in got.data] == \
            ["mov0.flac"]


def _wind(root):
    for i in range(3):
        name = os.path.join(root, f"take{i}")
        save_tsv(name + ".tsv", _write_clip(name + ".flac", seed=10 + i))


@pytest.mark.parametrize("kw", [{}, dict(sequence_length=16 * 512, seed=7)])
def test_application_wind_matches_jax(tmp_path, kw):
    port_root, jax_root = _twins(tmp_path, _wind)
    got = datasets.ApplicationWind(port_root, verbose=False, **kw)
    ref = jdatasets.ApplicationWind(jax_root, verbose=False, **kw)
    assert got.groups == ref.groups == ["dummy"]
    _same_datasets(got, ref, port_root, jax_root)


def test_dataset_files_missing_labels_raise(tmp_path):
    _write_clip(str(tmp_path / "lonely.flac"))
    with pytest.raises(FileNotFoundError, match="lonely.tsv"):
        datasets.ApplicationWind(str(tmp_path), verbose=False)


def _corpora(root):
    maps = os.path.join(root, "MAPS")
    synth_data.make_maps_like(maps, groups=("AkPnBcht", "SptkBGAm"),
                              duration_s=1.5)
    for i, group in enumerate(("ENSTDkAm", "ENSTDkCl")):
        synth_data.make_maps_like(maps, groups=(group,), duration_s=1.5,
                                  seed=60 + i)
    synth_data.make_maestro_like(os.path.join(root, "MAESTRO"), n_files=2,
                                 duration_s=1.5)
    net = os.path.join(root, "MusicNet")
    for mode, ids in (("train", ("1001",)), ("test", ("2106",))):
        os.makedirs(os.path.join(net, f"{mode}_data"))
        os.makedirs(os.path.join(net, f"tsv_{mode}_labels"))
        with open(os.path.join(net, f"{mode}_metadata.csv"), "w") as f:
            f.write("id,ensemble\n" + "".join(
                f"{i},String train\n" for i in ids))
        for i in ids:
            save_tsv(os.path.join(net, f"tsv_{mode}_labels", i + ".tsv"),
                     _write_clip(os.path.join(net, f"{mode}_data",
                                              i + ".flac"), seed=int(i)))


@pytest.mark.parametrize("train_on", ["MAPS", "MAESTRO", "MusicNet"])
def test_prepare_dataset_matches_jax(tmp_path, train_on):
    """`prepare_dataset`'s (training, validation, full validation) sets
    on each branch, the roots given by `data_roots` to one package and by
    the RECONVAT_*_ROOT variables to the other."""
    port_root, jax_root = _twins(tmp_path, _corpora)
    names = ("MAPS", "MAESTRO", "MusicNet")
    args = (train_on, 8 * 512, 16 * 512, None, False)
    got = prepare.prepare_dataset(*args, data_roots={
        k: os.path.join(port_root, k) for k in names})
    with pytest.MonkeyPatch.context() as mp:
        for k in names:
            mp.setenv(f"RECONVAT_{k.upper()}_ROOT", os.path.join(jax_root, k))
        ref = jprepare.prepare_dataset(*args)
    assert len(got[0]) > 0 and len(got[2]) == 2
    for a, b in zip(got, ref, strict=True):
        assert a.groups == b.groups
        if len(b) == 0:
            assert len(a) == 0
            continue
        _same_datasets(a, b, port_root, jax_root)


def _rolls(seed, T=200, P=12):
    rng = np.random.RandomState(seed)
    onsets = (rng.rand(T, P) < 0.1).astype(np.float32)
    frames = np.maximum((rng.rand(T, P) < 0.3).astype(np.float32), onsets)
    onsets = onsets * (0.5 + 0.5 * rng.rand(T, P))
    frames = frames * (0.5 + 0.5 * rng.rand(T, P))
    velocity = rng.rand(T, P).astype(np.float32)
    return onsets, frames, velocity


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_notes_and_notes_to_frames_match_jax(seed):
    onsets, frames, velocity = _rolls(seed)
    got = decode.extract_notes(onsets, frames, velocity, 0.6, 0.4)
    ref = jdecode.extract_notes(onsets, frames, velocity, 0.6, 0.4)
    for a, b in zip(got, ref, strict=True):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert len(got[0]) > 0
    t, f = decode.notes_to_frames(got[0], got[1], onsets.shape)
    jt, jf = jdecode.notes_to_frames(ref[0], ref[1], onsets.shape)
    np.testing.assert_array_equal(t, jt)
    assert len(f) == len(jf) == onsets.shape[0]
    for a, b in zip(f, jf):
        np.testing.assert_array_equal(a, b)
    empty = np.zeros_like(onsets)
    for a, b in zip(decode.extract_notes(empty, empty, velocity),
                    jdecode.extract_notes(empty, empty, velocity)):
        assert len(a) == len(b) == 0


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_write_midi_events_and_wav_are_byte_equal(tmp_path):
    tracks = [[(0, [0xFF, 0x51, 0x03, 0x07, 0xA1, 0x20]), (0, [0x90, 60, 100]),
               (960, [0x80, 60, 0]), (480, [0xB0, 64, 127])],
              [(10, [0x91, 72, 30]), (2000, [0x81, 72, 0])]]
    for tpb in (480, 96):
        midi_io.write_midi_events(str(tmp_path / "a.mid"), tracks, tpb)
        jmidi_io.write_midi_events(str(tmp_path / "b.mid"), tracks, tpb)
        assert _read(tmp_path / "a.mid") == _read(tmp_path / "b.mid")
    pcm = (np.random.RandomState(0).randn(5000) * 3000).astype(np.int16)
    for sr in (16000, 44100):
        audio_io.write_wav(str(tmp_path / "a.wav"), pcm, sr)
        jaudio_io.write_wav(str(tmp_path / "b.wav"), pcm, sr)
        assert _read(tmp_path / "a.wav") == _read(tmp_path / "b.wav")
    got, sr = audio_io.read_audio(str(tmp_path / "a.wav"))
    assert sr == 44100
    np.testing.assert_array_equal(got, pcm)


def _midis(root):
    rng = np.random.RandomState(3)
    for i, ext in enumerate((".mid", ".midi")):
        on = np.sort(rng.rand(12) * 5)
        midi_io.save_midi(os.path.join(root, f"song{i}{ext}"),
                          midi_io.midi_to_hz(rng.randint(21, 109, 12)),
                          np.stack([on, on + 0.2 + rng.rand(12)], 1),
                          rng.rand(12))
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("not a MIDI file\n")


def test_midi_files_to_tsv_matches_jax(tmp_path):
    port_root, jax_root = _twins(tmp_path, _midis)
    names = ("song0.mid", "song1.midi", "notes.txt")
    got = midi_io.midi_files_to_tsv([os.path.join(port_root, n)
                                     for n in names], n_jobs=2)
    ref = jmidi_io.midi_files_to_tsv([os.path.join(jax_root, n)
                                      for n in names], n_jobs=2)
    assert [os.path.relpath(p, port_root) for p in got] == \
        [os.path.relpath(p, jax_root) for p in ref] == \
        ["song0.tsv", "song1.tsv"]
    for a, b in zip(got, ref):
        assert _read(a) == _read(b)


def test_midi_io_module_cli(tmp_path):
    """`python -m reconvat_tpu_torch.data.midi_io` writes what the JAX
    package's converter writes, and prints each output's path."""
    port_root, jax_root = _twins(tmp_path, _midis)
    proc = subprocess.run(
        [sys.executable, "-m", "reconvat_tpu_torch.data.midi_io",
         os.path.join(port_root, "song0.mid"),
         os.path.join(port_root, "song1.midi")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [os.path.join(port_root, n)
                                   for n in ("song0.tsv", "song1.tsv")]
    ref = jmidi_io.midi_files_to_tsv([os.path.join(jax_root, "song0.mid"),
                                      os.path.join(jax_root, "song1.midi")])
    for name, path in zip(("song0.tsv", "song1.tsv"), ref):
        assert _read(os.path.join(port_root, name)) == _read(path)


def test_preprocess_audio_matches_tool(tmp_path):
    """The port's staging CLI and `tools/preprocess_audio.py` on the same
    inputs (a 44.1 kHz stereo wav, resampled, and a 16 kHz FLAC, kept):
    byte-equal wav and placeholder .tsv files, and the same lines."""
    from scipy.io import wavfile

    src = tmp_path / "src"
    src.mkdir()
    t = np.arange(44100) / 44100
    tone = np.sin(2 * np.pi * 440 * t) * 20000
    wavfile.write(str(src / "clip.wav"), 44100,
                  np.stack([tone, 0.5 * tone], 1).astype(np.int16))
    _write_clip(str(src / "take.flac"), seed=5, duration=1.0)
    inputs = [str(src / "clip.wav"), str(src / "take.flac")]
    outs = {}
    for who, cmd in (("port", [sys.executable, "-m",
                               "reconvat_tpu_torch.preprocess_audio"]),
                     ("tool", [sys.executable,
                               os.path.join(REPO, "tools",
                                            "preprocess_audio.py")])):
        out = tmp_path / who
        proc = subprocess.run(cmd + ["--out-dir", str(out), "--dummy-tsv"]
                              + inputs, cwd=REPO, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[who] = (out, proc.stdout.replace(str(out), "<out>"))
    (port, port_log), (tool, tool_log) = outs["port"], outs["tool"]
    assert port_log == tool_log
    names = sorted(os.listdir(tool))
    assert names == sorted(os.listdir(port)) == [
        "clip.tsv", "clip.wav", "take.tsv", "take.wav"]
    for name in names:
        assert _read(port / name) == _read(tool / name), name
    pcm, sr = audio_io.read_audio(str(port / "clip.wav"))
    assert sr == 16000 and abs(len(pcm) - 16000) < 4
    ds = datasets.ApplicationDataset(str(port))
    assert len(ds) == 2
