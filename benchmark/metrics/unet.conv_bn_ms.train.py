"""Device ms per step in the U-Net's convolution and BatchNorm kernels
(cuDNN forward, dgrad and wgrad, the BatchNorm kernels), from the traced
slice."""
from benchmark.groups import ATTN_BWD, ATTN_FWD, CONV_BN, MEL


def read(run):
    s = run.slice
    if run.kind != "train" or s is None or not s.units:
        return None
    seconds, _ = s.device_s(*CONV_BN, exclude=MEL + ATTN_FWD + ATTN_BWD)
    return seconds / s.units * 1e3, "ms"
