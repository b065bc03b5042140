"""Single-track MIDI export (the port's copy of
`reconvat_tpu/data/midi_io.py:27-47, 190-233`; pure Python, no mido).

`save_midi` reproduces the reference MIDI export math (reference
`model/midi.py:53-84`): 480 ticks/beat at 120 bpm => 960 ticks/second,
`int(time * 960)` truncation, velocity `int(v * 127)` clamped to 127.
"""
from __future__ import annotations

import struct

import numpy as np

DEFAULT_TICKS_PER_BEAT = 480


def _write_varint(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative delta time")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


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
