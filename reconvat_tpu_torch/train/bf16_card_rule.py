"""`chip_smoke.py` phase 9b's rule over several weight states, on the card.

    python -m reconvat_tpu_torch.train.bf16_card_rule [n_states]

Trains the fp32 ReconVAT at phase 6's shape (B = 8 + 8 clips of 20.48 s,
VAT, `chip_smoke.train_batches`) for 4 steps at a time, and after each 4
(8 states by default) holds the bf16 step on phase 9's short clip (2 x 32
frames, no VAT), the card against the CPU, by `chip_smoke.median_rule`
over two kinds of draws: `BF16_9B_DRAWS` weight draws
(`chip_smoke.weight_draws`, phase 9b's), and as many audio copies
(`chip_smoke.probe_batches`) at the present weights. Prints, per state
and per prediction, the upper bound's share of its limit, the card's
move over the CPU's and, over the weight draws, the share of the second
reading's limit (+ `PROBE_FACTOR` x the CPU bf16 route's spread,
`chip_smoke.bf16_spread`), with the spread. Needs one CUDA device and
nvcc.
"""
from __future__ import annotations

import os
import sys

import torch


def main(n_states: int = 8) -> None:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs

    from ..kernels import _build
    from ..models.reconvat import ReconVAT
    from .state import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    model = ReconVAT(seed=0)
    state = create_train_state(model)
    step = make_train_step(model, alpha=1.0, vat=True, use_unlabeled=True)
    batches = [cs.train_batches(seed) for seed in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    short_l = {k: v[:2, :32 * 512] if k == "audio" else v[:2, :32]
               for k, v in batches[0][0].items()}
    copies = [short_l] + [d for d, _ in cs.probe_batches(
        short_l, None, cs.BF16_9B_DRAWS, seed=17)]
    routes = {"card16": ReconVAT(seed=0, compute_dtype="bfloat16"),
              "card32": ReconVAT(seed=0),
              "cpu16": ReconVAT(seed=0, device="cpu",
                                compute_dtype="bfloat16"),
              "cpu32": ReconVAT(seed=0, device="cpu")}
    print(cs.nvidia_smi())
    for k in range(n_states):
        for i in range(4):
            step(state, *batches[i % 2], gen)
        start = {n: v.clone() for n, v in model.state_dict().items()}
        by_weights = {n: [] for n in routes}
        states = cs.weight_draws(start, cs.BF16_9B_DRAWS, seed=19)
        for weights in states:
            for name, m in routes.items():
                m.load_state_dict(weights)
                by_weights[name].append(cs.short_step(m, short_l)[0])
        by_audio = {}
        for name, m in routes.items():
            m.load_state_dict(start)
            by_audio[name] = [cs.short_step(m, x)[0] for x in copies]
        spread = cs.bf16_spread(routes["cpu16"], states, short_l)
        for label, runs, sp in (("weight draws", by_weights, spread),
                                ("audio copies", by_audio, None)):
            misses, read = cs.median_rule(runs["card16"], runs["cpu16"],
                                          runs["card32"], runs["cpu32"], sp)
            print(f"after {4 * (k + 1)} steps, {label}: (upper share, "
                  f"move{'' if sp is None else ', second share'}) {read}; "
                  f"misses {misses}"
                  + ("" if sp is None else f"; spread {sp}"), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
