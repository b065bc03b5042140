"""`mel_power`'s share of its roofline in serving (counts/mel.py)."""
from benchmark.groups import MEL
from benchmark.roofline import share


def read(run):
    return share(run, "mel", MEL) if run.kind == "serve" else None
