"""The banded attention forward's share of its roofline in serving
(counts/attn_fwd.py)."""
from benchmark.groups import ATTN_FWD
from benchmark.roofline import share


def read(run):
    return share(run, "attn_fwd", ATTN_FWD) if run.kind == "serve" else None
