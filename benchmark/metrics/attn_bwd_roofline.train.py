"""The banded attention backward's share of its roofline in training,
both passes (counts/attn_bwd.py)."""
from benchmark.groups import ATTN_BWD, ATTN_BWD_FIRST
from benchmark.roofline import share


def read(run):
    if run.kind != "train":
        return None
    return share(run, "attn_bwd", ATTN_BWD, ATTN_BWD_FIRST)
