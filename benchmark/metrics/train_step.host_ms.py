"""Host ms per step inside the `train_step` call (zero_grad, the VAT
step's forwards and backwards enqueued, clipping, Adam, StepLR)."""


def read(run):
    times = run.spans.get("train_step.host")
    if run.kind != "train" or not times:
        return None
    return sum(times) / len(times) * 1e3, "ms"
