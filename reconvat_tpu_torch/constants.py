"""Global signal-chain constants (the port's own copy of
`reconvat_tpu/constants.py`).

Mirrors the reference configuration (ReconVAT `model/constants.py:4-23`):
16 kHz audio, 512-sample hop (32 ms -> 31.25 fps), 88 piano keys
(MIDI 21-108), 229 mel bins between 30 Hz and Nyquist, 2048-sample window.
"""

SAMPLE_RATE = 16000
HOP_LENGTH = SAMPLE_RATE * 32 // 1000          # 512
ONSET_LENGTH = SAMPLE_RATE * 32 // 1000        # 512
OFFSET_LENGTH = SAMPLE_RATE * 32 // 1000       # 512
HOPS_IN_ONSET = ONSET_LENGTH // HOP_LENGTH     # 1
HOPS_IN_OFFSET = OFFSET_LENGTH // HOP_LENGTH   # 1
MIN_MIDI = 21
MAX_MIDI = 108
N_KEYS = MAX_MIDI - MIN_MIDI + 1               # 88

N_BINS = 229            # mel bins of the default frontend
MEL_FMIN = 30
MEL_FMAX = SAMPLE_RATE // 2

WINDOW_LENGTH = 2048

# Frames per second of the posteriogram time axis.
FRAME_RATE = SAMPLE_RATE / HOP_LENGTH          # 31.25
