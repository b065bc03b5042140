"""Peak device memory and run-to-run reproducibility of the transcriber's
forward at the streaming path's shapes, on one GPU:

    python -m reconvat_tpu_torch.models.streaming_probe

For each (B x T frames), the peak device memory of one eval forward of the
first-pass transcriber (fp32, TF32 off) above what was allocated before
it, with cuDNN on and off; the leaf module whose forward raises the peak
most at 1 x 896 frames (one window of `transcribe_streaming` at its
defaults); and the largest difference between two forwards of the same
input, with cuDNN's `deterministic` off and on, for the U-Net encoder
alone and for the whole transcriber. Random weights from seed 0, inputs
from seed 1. Needs CUDA; prints one line per reading.
"""
from __future__ import annotations

import torch

from ..kernels import _build
from .reconvat import ReconVAT

SHAPES = ((1, 896), (2, 896), (4, 896), (1, 1024), (1, 9728))


def peak_gb(fn) -> float:
    """Peak device GB of fn() above the memory allocated before it, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def forward(model, spec, cudnn: bool = True, deterministic: bool = False):
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=cudnn, deterministic=deterministic, allow_tf32=False):
        return model.transcriber(spec)[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("streaming_probe: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    model = ReconVAT(seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    for b, t in SHAPES:
        spec = torch.rand((b, t, model.n_bins, 1), generator=g,
                          device="cuda")
        on = peak_gb(lambda: forward(model, spec))
        off = peak_gb(lambda: forward(model, spec, cudnn=False))
        print(f"transcriber forward at {b} x {t} frames: peak GB above its "
              f"base, cuDNN on {on}, cuDNN off {off}")

    spec = torch.rand((1, 896, model.n_bins, 1), generator=g, device="cuda")
    peaks = []

    def pre(m, args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m.probe_base = torch.cuda.memory_allocated()

    def post(m, args, out):
        torch.cuda.synchronize()
        peaks.append(((torch.cuda.max_memory_allocated() - m.probe_base)
                      / 1e9, m.probe_name))

    hooks = []
    for name, m in model.transcriber.named_modules():
        if not list(m.children()):
            m.probe_name = name
            hooks += [m.register_forward_pre_hook(pre),
                      m.register_forward_hook(post)]
    forward(model, spec)
    for h in hooks:
        h.remove()
    print(f"largest leaf peaks at 1 x 896 frames (GB, module): "
          f"{sorted(peaks, reverse=True)[:3]}")

    encoder = model.transcriber.Unet1_encoder
    x = spec.permute(0, 3, 1, 2)
    for det in (False, True):
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, deterministic=det, allow_tf32=False):
            e = [encoder(x)[0] for _ in range(3)]
        t = [forward(model, spec, deterministic=det) for _ in range(3)]
        print(f"cudnn.deterministic={det}: largest difference between "
              f"repeated forwards at 1 x 896 frames, encoder "
              f"{max((a - e[0]).abs().max().item() for a in e)}, "
              f"transcriber {max((a - t[0]).abs().max().item() for a in t)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
