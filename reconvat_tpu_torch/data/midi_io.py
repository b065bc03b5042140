"""MIDI read and write (the port's copy of `reconvat_tpu/data/midi_io.py`;
pure Python, no mido).

`parse_midi` reproduces the reference label-extraction semantics
(reference `model/midi.py:12-50`): tempo-aware tick->second conversion over
merged tracks, sustain-pedal (CC64) offset extension, (onset, offset, note,
velocity) rows.

`save_midi` reproduces the reference MIDI export math (reference
`model/midi.py:53-84`): 480 ticks/beat at 120 bpm => 960 ticks/second,
`int(time * 960)` truncation, velocity `int(v * 127)` clamped to 127.
`write_midi_events` writes any tracks of (tick, event bytes).

`midi_files_to_tsv` converts MIDI files to the label .tsv files the
datasets read (reference `model/midi.py:87-106`):

    python -m reconvat_tpu_torch.data.midi_io a.mid b.midi ...

writes `a.tsv`, `b.tsv`, ... beside them and prints their paths.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

DEFAULT_TICKS_PER_BEAT = 480
DEFAULT_TEMPO = 500000  # microseconds per beat (120 bpm)


def _read_varint(data: bytes, pos: int):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _write_varint(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative delta time")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


@dataclass
class MidiEvent:
    tick: int
    status: int          # full status byte (e.g. 0x90 | channel)
    data: tuple          # data bytes, or meta payload
    meta_type: int | None = None


def _parse_track(data: bytes):
    events = []
    pos = 0
    tick = 0
    running_status = None
    while pos < len(data):
        delta, pos = _read_varint(data, pos)
        tick += delta
        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running_status = status
        else:
            if running_status is None:
                raise ValueError("running status without prior status byte")
            status = running_status

        if status == 0xFF:  # meta
            meta_type = data[pos]
            pos += 1
            length, pos = _read_varint(data, pos)
            payload = data[pos:pos + length]
            pos += length
            events.append(MidiEvent(tick, status, tuple(payload), meta_type))
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_varint(data, pos)
            pos += length
        else:
            kind = status & 0xF0
            n_data = 1 if kind in (0xC0, 0xD0) else 2
            payload = tuple(data[pos:pos + n_data])
            pos += n_data
            events.append(MidiEvent(tick, status, payload))
    return events


def read_midi_file(path: str):
    """Returns (ticks_per_beat, merged event list sorted by tick)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"not a MIDI file: {path}")
    hlen = struct.unpack(">I", data[4:8])[0]
    fmt, ntracks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    pos = 8 + hlen
    tracks = []
    for _ in range(ntracks):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        tracks.append(_parse_track(data[pos + 8:pos + 8 + tlen]))
        pos += 8 + tlen
    # stable merge across tracks by absolute tick (mido merge_tracks order)
    merged = []
    for ti, track in enumerate(tracks):
        for ei, ev in enumerate(track):
            merged.append((ev.tick, ti, ei, ev))
    merged.sort(key=lambda r: (r[0], r[1], r[2]))
    return division, [ev for _, _, _, ev in merged]


def iter_messages_seconds(path: str):
    """Yield (seconds_since_start, kind, note_or_control, velocity_or_value).

    kind in {'note_on', 'note_off', 'control_change', 'set_tempo', ...}.
    Tick deltas are converted to seconds with the tempo active *before* each
    event, matching mido's playback iteration used by the reference.
    """
    ticks_per_beat, events = read_midi_file(path)
    tempo = DEFAULT_TEMPO
    now = 0.0
    last_tick = 0
    for ev in events:
        delta_ticks = ev.tick - last_tick
        last_tick = ev.tick
        now += delta_ticks * tempo / 1e6 / ticks_per_beat
        if ev.meta_type == 0x51:  # set_tempo
            tempo = (ev.data[0] << 16) | (ev.data[1] << 8) | ev.data[2]
            yield now, "set_tempo", tempo, 0
            continue
        if ev.meta_type is not None:
            continue
        kind = ev.status & 0xF0
        if kind == 0x90:
            note, vel = ev.data
            yield now, ("note_on" if vel > 0 else "note_on"), note, vel
        elif kind == 0x80:
            note, vel = ev.data
            yield now, "note_off", note, vel
        elif kind == 0xB0:
            control, value = ev.data
            yield now, "control_change", control, value


# ---------------------------------------------------------------------------
# Reference-compatible high level API
# ---------------------------------------------------------------------------

def parse_midi(path: str) -> np.ndarray:
    """MIDI file -> np.array of (onset, offset, note, velocity) rows.

    Exact port of the reference event walk (`model/midi.py:12-50`):
    sustain-pedal state extends offsets to the pedal release.
    """
    sustain = False
    events = []
    for time, kind, a, b in iter_messages_seconds(path):
        if kind == "control_change" and a == 64 and (b >= 64) != sustain:
            sustain = b >= 64
            event_type = "sustain_on" if sustain else "sustain_off"
            events.append(dict(index=len(events), time=time, type=event_type,
                               note=None, velocity=0))
        if kind in ("note_on", "note_off"):
            velocity = b if kind == "note_on" else 0
            events.append(dict(index=len(events), time=time, type="note",
                               note=a, velocity=velocity, sustain=sustain))

    notes = []
    for i, onset in enumerate(events):
        if onset["velocity"] == 0:
            continue
        offset = next(n for n in events[i + 1:]
                      if n["note"] == onset["note"] or n is events[-1])
        if offset.get("sustain") and offset is not events[-1]:
            offset = next(n for n in events[offset["index"] + 1:]
                          if n["type"] == "sustain_off" or n is events[-1])
        notes.append((onset["time"], offset["time"], onset["note"],
                      onset["velocity"]))
    return np.array(notes)


def hz_to_midi(freq):
    return 12.0 * (np.log2(np.asarray(freq)) - np.log2(440.0)) + 69.0


def midi_to_hz(midi):
    return 440.0 * (2.0 ** ((np.asarray(midi) - 69.0) / 12.0))


def save_midi(path: str, pitches, intervals, velocities):
    """Save note events as a single-track MIDI file.

    pitches are in Hz (converted back via hz_to_midi), intervals in seconds,
    velocities in [0, 1]; tick arithmetic matches the reference
    (`model/midi.py:53-84`).
    """
    ticks_per_second = DEFAULT_TICKS_PER_BEAT * 2.0

    events = []
    for i in range(len(pitches)):
        events.append(dict(type="on", pitch=pitches[i],
                           time=intervals[i][0], velocity=velocities[i]))
        events.append(dict(type="off", pitch=pitches[i],
                           time=intervals[i][1], velocity=velocities[i]))
    events.sort(key=lambda row: row["time"])

    track = bytearray()
    last_tick = 0
    for event in events:
        current_tick = int(event["time"] * ticks_per_second)
        velocity = int(event["velocity"] * 127)
        if velocity > 127:
            velocity = 127
        pitch = int(round(hz_to_midi(event["pitch"])))
        status = 0x90 if event["type"] == "on" else 0x80
        track += _write_varint(current_tick - last_tick)
        track += bytes([status, pitch & 0x7F, velocity & 0x7F])
        last_tick = current_tick
    # end of track
    track += _write_varint(0) + bytes([0xFF, 0x2F, 0x00])

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 1, 1,
                                      DEFAULT_TICKS_PER_BEAT))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))


def midi_files_to_tsv(paths, n_jobs: int | None = None):
    """Batch midi -> tsv conversion (reference `model/midi.py:87-106` CLI)."""
    import concurrent.futures
    import os

    def process(input_file):
        if input_file.endswith(".mid"):
            output_file = input_file[:-4] + ".tsv"
        elif input_file.endswith(".midi"):
            output_file = input_file[:-5] + ".tsv"
        else:
            print(f"ignoring non-MIDI file {input_file}")
            return None
        midi_data = parse_midi(input_file)
        np.savetxt(output_file, midi_data, "%.6f", "\t",
                   header="onset\toffset\tnote\tvelocity")
        return output_file

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=n_jobs or os.cpu_count()) as ex:
        return [r for r in ex.map(process, paths) if r]


def write_midi_events(path: str, tracks,
                      ticks_per_beat=DEFAULT_TICKS_PER_BEAT):
    """General multi-track writer; tracks = list of [(tick, status_bytes)]."""
    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks),
                                      ticks_per_beat))
        for events in tracks:
            track = bytearray()
            last = 0
            for tick, payload in sorted(events, key=lambda e: e[0]):
                track += _write_varint(tick - last) + bytes(payload)
                last = tick
            track += _write_varint(0) + bytes([0xFF, 0x2F, 0x00])
            f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))


if __name__ == "__main__":
    import sys

    for out in midi_files_to_tsv(sys.argv[1:]):
        print(out)
