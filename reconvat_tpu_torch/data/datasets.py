"""Datasets: MAPS, MAESTRO, MusicNet, Guqin, Corelli and ApplicationWind
for training, and the unlabeled input folder of the transcription CLI (the
port's copy of `reconvat_tpu/data/datasets.py`, reference
`model/dataset.py`).

Same group tables, split logic, crop math (a `np.random.RandomState(seed)`
per dataset, so a seed gives the JAX package's crops) and label codes.
Corpora load eagerly into host numpy; the audio and label rolls are cached
as `.reconvat.npz` beside each audio file, as in the JAX package.
`__getitem__` returns host numpy; the loader (`loader.py`) moves batches to
the device. MusicNet's metadata is read with `csv` (no pandas).
"""
from __future__ import annotations

import csv
import json
import os
import pickle
import re
from glob import glob

import numpy as np

from .. import constants as C
from . import audio_io
from .labels import label_to_masks, load_tsv, save_tsv, tsv_to_rolls
from .midi_io import parse_midi


def _check_files(flacs, tsvs):
    missing = [f for f in list(flacs) + list(tsvs) if not os.path.isfile(f)]
    if missing:
        raise FileNotFoundError(f"dataset files missing: {missing}")


CACHE_SUFFIX = ".reconvat.npz"


class PianoRollAudioDataset:
    """Base: eager-loads the corpus, serves random hop-aligned crops
    (reference `model/dataset.py:19-142`)."""

    def __init__(self, path, groups=None, sequence_length=None, seed=42,
                 refresh=False, verbose=True):
        self.path = path
        self.groups = groups if groups is not None \
            else self.available_groups()
        self.sequence_length = sequence_length
        self.random = np.random.RandomState(seed)
        self.refresh = refresh

        self.data = []
        if verbose:
            print(f"Loading {len(self.groups)} group"
                  f"{'s' if len(self.groups) > 1 else ''} "
                  f"of {type(self).__name__} at {path}")
        for group in self.groups:
            for input_files in self.files(group):
                self.data.append(self.load(*input_files))

    # -- to be provided by subclasses ---------------------------------------
    @classmethod
    def available_groups(cls):
        raise NotImplementedError

    def files(self, group):
        raise NotImplementedError

    # ------------------------------------------------------------------------
    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        data = self.data[index]
        result = dict(path=data["path"])

        if self.sequence_length is not None:
            audio_length = len(data["audio"])
            step_begin = self.random.randint(
                audio_length - self.sequence_length) // C.HOP_LENGTH
            n_steps = self.sequence_length // C.HOP_LENGTH
            step_end = step_begin + n_steps
            begin = step_begin * C.HOP_LENGTH
            end = begin + self.sequence_length

            audio = data["audio"][begin:end]
            label = data["label"][step_begin:step_end]
            velocity = data["velocity"][step_begin:step_end]
            result["start_idx"] = begin
        else:
            audio = data["audio"]
            label = data["label"]
            velocity = data["velocity"]

        result["audio"] = audio.astype(np.float32) / 32768.0
        onset, offset, frame = label_to_masks(label)
        result["onset"] = onset
        result["offset"] = offset
        result["frame"] = frame
        result["velocity"] = velocity.astype(np.float32) / 128.0
        return result

    def load(self, audio_path, tsv_path):
        cache = os.path.splitext(audio_path)[0] + CACHE_SUFFIX
        if os.path.exists(cache) and not self.refresh:
            z = np.load(cache, allow_pickle=False)
            return dict(path=audio_path, audio=z["audio"],
                        label=z["label"], velocity=z["velocity"])
        audio, sr = audio_io.read_audio(audio_path)
        if sr != C.SAMPLE_RATE:
            raise ValueError(f"{audio_path}: expected {C.SAMPLE_RATE} Hz, "
                             f"got {sr}")

        midi = load_tsv(tsv_path)
        label, velocity = tsv_to_rolls(midi, len(audio))
        # written whole under another name and renamed: the ranks of a
        # data-parallel run prepare the same files at once, and a reader
        # must never open a cache that another rank is still writing
        part = f"{cache}.{os.getpid()}.part"
        with open(part, "wb") as f:
            np.savez(f, audio=audio, label=label, velocity=velocity)
        os.replace(part, cache)
        return dict(path=audio_path, audio=audio, label=label,
                    velocity=velocity)


def _filter_overlap(flacs, base_dir, supersmall):
    """MAPS/Corelli `overlap=False` filtering via overlapping.pkl
    (reference `model/dataset.py:196-207`)."""
    pkl = "overlapping.pkl"
    if not os.path.exists(pkl):
        cand = os.path.join(base_dir, pkl)
        if os.path.exists(cand):
            pkl = cand
        else:
            raise FileNotFoundError(
                "overlap=False requires overlapping.pkl (test-song name "
                "substrings) in the working directory or dataset root")
    with open(pkl, "rb") as f:
        test_names = pickle.load(f)
    filtered = [f for f in flacs
                if not any(sub in f for sub in test_names)]
    filtered = sorted(filtered)
    if supersmall:
        filtered = [sorted(filtered)[3]]
    return filtered


class MAPS(PianoRollAudioDataset):
    def __init__(self, path="./MAPS", groups=None, sequence_length=None,
                 overlap=True, seed=42, refresh=False, supersmall=False,
                 **kw):
        self.overlap = overlap
        self.supersmall = supersmall
        super().__init__(path, groups if groups is not None
                         else ["ENSTDkAm", "ENSTDkCl"],
                         sequence_length, seed, refresh, **kw)

    @classmethod
    def available_groups(cls):
        return ["AkPnBcht", "AkPnBsdf", "AkPnCGdD", "AkPnStgb", "ENSTDkAm",
                "ENSTDkCl", "SptkBGAm", "SptkBGCl", "StbgTGd2"]

    def files(self, group):
        flacs = glob(os.path.join(self.path, "flac", f"*_{group}.flac"))
        flacs += glob(os.path.join(self.path, "flac", f"*_{group}.wav"))
        if not self.overlap:
            flacs = _filter_overlap(flacs, self.path, self.supersmall)
        tsvs = [os.path.join(
            self.path, "tsvs",
            os.path.splitext(os.path.basename(f))[0] + ".tsv")
            for f in flacs]
        _check_files(flacs, tsvs)
        return sorted(zip(flacs, tsvs))


class MAESTRO(PianoRollAudioDataset):
    def __init__(self, path="../../public_data/MAESTRO/", groups=None,
                 sequence_length=None, seed=42, refresh=False, **kw):
        super().__init__(path, groups if groups is not None else ["train"],
                         sequence_length, seed, refresh, **kw)

    @classmethod
    def available_groups(cls):
        return ["train", "validation", "test"]

    def files(self, group):
        if group not in self.available_groups():
            # year-based grouping
            flacs = sorted(glob(os.path.join(self.path, group, "*.flac")))
            if len(flacs) == 0:
                flacs = sorted(glob(os.path.join(self.path, group, "*.wav")))
            midis = sorted(glob(os.path.join(self.path, group, "*.midi")))
            files = list(zip(flacs, midis))
            if len(files) == 0:
                raise RuntimeError(f"Group {group} is empty")
        else:
            meta_path = os.path.join(self.path, "maestro-v2.0.0.json")
            metadata = json.load(open(meta_path))
            files = sorted([
                (os.path.join(self.path,
                              row["audio_filename"].replace(".wav", ".flac")),
                 os.path.join(self.path, row["midi_filename"]))
                for row in metadata if row["split"] == group])
            files = [(audio if os.path.exists(audio)
                      else audio.replace(".flac", ".wav"), midi)
                     for audio, midi in files]

        result = []
        for audio_path, midi_path in files:
            tsv = midi_path.replace(".midi", ".tsv").replace(".mid", ".tsv")
            if not os.path.exists(tsv):
                save_tsv(tsv, parse_midi(midi_path))
            result.append((audio_path, tsv))
        return result


class MusicNet(PianoRollAudioDataset):
    STRING_KEYS = ["Solo Violin", "Violin and Harpsichord",
                   "Accompanied Violin", "String Quartet", "String Sextet",
                   "Viola Quintet", "Solo Cello", "Accompanied Cello"]
    WIND_KEYS = ["Accompanied Clarinet", "Clarinet Quintet",
                 "Pairs Clarinet-Horn-Bassoon", "Clarinet-Cello-Piano Trio",
                 "Wind Octet", "Wind Quintet"]

    def __init__(self, path="./MusicNet", groups=None, sequence_length=None,
                 seed=42, refresh=False, **kw):
        super().__init__(path, groups if groups is not None else ["train"],
                         sequence_length, seed, refresh, **kw)

    @classmethod
    def available_groups(cls):
        return ["train", "test"]

    def _meta(self, mode):
        """The metadata table's rows as dicts (csv, no pandas)."""
        path = os.path.join(self.path, f"{mode}_metadata.csv")
        with open(path, newline="") as f:
            return list(csv.DictReader(f))

    def _ids(self, meta, key):
        """The ids of the rows whose ensemble matches `key` (a regular
        expression searched in it, as pandas' `str.contains`)."""
        return [row["id"] for row in meta if re.search(key, row["ensemble"])]

    def read_id(self, group, mode):
        return self._ids(self._meta(mode), group)

    def _flac_tsv(self, id_list, mode):
        flacs, tsvs = [], []
        for i in id_list:
            hits = glob(os.path.join(self.path, f"{mode}_data",
                                     f"{i}.flac"))
            if not hits:
                # wav fallback ONLY when no flac exists for the id —
                # globbing both unconditionally would duplicate entries and
                # zip-mismatch audio/tsv pairs downstream
                hits = glob(os.path.join(self.path, f"{mode}_data",
                                         f"{i}.wav"))
            flacs.extend(hits)
            tsvs.extend(glob(os.path.join(self.path, f"tsv_{mode}_labels",
                                          f"{i}.tsv")))
        return sorted(flacs), sorted(tsvs)

    def _first_per_key(self, keys, take_first):
        meta = self._meta("train")
        ids = []
        for key in keys:
            vals = self._ids(meta, key)
            ids.extend(vals[:1] if take_first else vals[1:])
        return ids

    def files(self, group):
        if group == "small test":
            flacs = sorted(sum((glob(os.path.join(self.path, "test_data", t))
                                for t in ("2303.flac", "2382.flac",
                                          "1819.flac")), []))
            tsvs = sorted(glob(os.path.join(self.path,
                                            "tsv_test_labels/*.tsv")))
        elif group == "train_string_l":
            flacs, tsvs = self._flac_tsv(
                self._first_per_key(self.STRING_KEYS, True), "train")
        elif group == "train_string_ul":
            flacs, tsvs = self._flac_tsv(
                self._first_per_key(self.STRING_KEYS, False), "train")
        elif group == "train_violin_l":
            ids = (self.read_id("Solo Violin", "train")
                   + self.read_id("Accompanied Violin", "train"))
            flacs, tsvs = self._flac_tsv(ids, "train")
        elif group == "train_violin_ul":
            ids = (self.read_id("String Quartet", "train")
                   + self.read_id("String Sextet", "train"))
            flacs, tsvs = self._flac_tsv(ids, "train")
        elif group == "test_violin":
            flacs, tsvs = self._flac_tsv(("2106", "2191", "2298", "2628"),
                                         "test")
        elif group == "train_wind_l":
            flacs, tsvs = self._flac_tsv(
                self._first_per_key(self.WIND_KEYS, True), "train")
        elif group == "train_wind_ul":
            flacs, tsvs = self._flac_tsv(
                self._first_per_key(self.WIND_KEYS, False), "train")
        elif group == "test_wind":
            flacs, tsvs = self._flac_tsv(("1819", "2416"), "test")
        elif group == "train_flute_l":
            flacs, tsvs = self._flac_tsv(("2203",), "train")
        elif group == "train_flute_ul":
            meta = self._meta("train")
            ids = []
            for key in self.WIND_KEYS:
                ids.extend(self._ids(meta, key))
            ids.append("2203")
            flacs, tsvs = self._flac_tsv(ids, "train")
        elif group == "test_flute":
            flacs, tsvs = self._flac_tsv(("2204",), "train")
        else:
            ids = self.read_id(group, "train")
            flacs, tsvs = self._flac_tsv(ids, "train")

        _check_files(flacs, tsvs)
        return list(zip(flacs, tsvs))


class Guqin(PianoRollAudioDataset):
    GROUP_SONGS = {
        "train_l": ["jiou", "siang", "ciou", "yi", "yu", "feng", "yang"],
        "train_ul": [],
        "test": ["gu", "guan", "liang"],
    }

    def __init__(self, path="./Guqin", groups=None, sequence_length=None,
                 seed=42, refresh=False, **kw):
        super().__init__(path, groups if groups is not None else ["train_l"],
                         sequence_length, seed, refresh, **kw)

    @classmethod
    def available_groups(cls):
        return ["train_l", "train_ul", "test"]

    def files(self, group):
        if group not in self.GROUP_SONGS:
            raise Exception("Please choose a valid group")
        flacs, tsvs = [], []
        for song in self.GROUP_SONGS[group]:
            flacs.extend(glob(os.path.join(self.path, "audio",
                                           song + ".flac")))
            tsvs.extend(glob(os.path.join(self.path, "tsv_label",
                                          song + ".tsv")))
        return list(zip(sorted(flacs), sorted(tsvs)))


class Corelli(PianoRollAudioDataset):
    """Corelli's string concertos (op. 6 nos. 1-3), one folder of .flac
    and .tsv files per group."""

    def __init__(self, path="./Application_String", groups=None,
                 sequence_length=None, overlap=True, seed=42, refresh=False,
                 supersmall=False, **kw):
        self.overlap = overlap
        self.supersmall = supersmall
        super().__init__(path, groups, sequence_length, seed, refresh, **kw)

    @classmethod
    def available_groups(cls):
        return ["op6_no1", "op6_no2", "op6_no3"]

    def files(self, group):
        flacs = glob(os.path.join(self.path, group, "*.flac"))
        if not self.overlap:
            flacs = _filter_overlap(flacs, self.path, self.supersmall)
        tsvs = [f.replace("/flac/", "/tsvs/").replace(".flac", ".tsv")
                for f in flacs]
        _check_files(flacs, tsvs)
        return sorted(zip(flacs, tsvs))


class ApplicationWind(PianoRollAudioDataset):
    """A wind-ensemble corpus: the folder's .flac files and a .tsv beside
    each (placeholder labels where the corpus is unlabeled, as
    `preprocess_audio --dummy-tsv` writes them), one group 'dummy'."""

    def __init__(self, path="./Application_Wind", groups=None,
                 sequence_length=None, overlap=True, seed=42, refresh=False,
                 supersmall=False, **kw):
        self.overlap = overlap
        self.supersmall = supersmall
        super().__init__(path, groups or ["dummy"], sequence_length, seed,
                         refresh, **kw)

    @classmethod
    def available_groups(cls):
        return ["dummy"]

    def files(self, group):
        flacs = glob(os.path.join(self.path, "*.flac"))
        if not self.overlap:
            flacs = _filter_overlap(flacs, self.path, self.supersmall)
        tsvs = [f.replace("/flac/", "/tsvs/").replace(".flac", ".tsv")
                for f in flacs]
        _check_files(flacs, tsvs)
        return sorted(zip(flacs, tsvs))


class ApplicationDataset:
    """Inference-only corpus: the folder's .flac and .wav files, 16 kHz,
    no labels. `seed` is taken and unused, as in the JAX package and the
    reference (`model/dataset.py:446-511`): nothing here is drawn."""

    def __init__(self, path, seed=42):
        self.path = path
        self.data = []
        for audio_path in self.files(path):
            audio, sr = audio_io.read_audio(audio_path)
            if sr != C.SAMPLE_RATE:
                raise ValueError(
                    f"Please make sure the sampling rate is 16k.\n"
                    f"{audio_path} has a sampling rate of {sr}")
            self.data.append(dict(path=audio_path, audio=audio))

    def files(self, path):
        flacs = glob(os.path.join(path, "*.flac"))
        flacs.extend(glob(os.path.join(path, "*.wav")))
        return sorted(flacs)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        d = self.data[index]
        return dict(path=d["path"],
                    audio=d["audio"].astype(np.float32) / 32768.0)
