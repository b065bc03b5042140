"""Host-side data: audio decode, MIDI export and the input folder."""
