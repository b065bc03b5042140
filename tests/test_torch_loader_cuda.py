"""`data.loader.prefetch_to_device` on a card: the batches arrive intact.

JAX-free, so it runs on the card's machine too
(`python -m pytest --noconftest tests/test_torch_loader_cuda.py`). The
test needs a CUDA device and skips without one.
"""
import numpy as np
import pytest
import torch

from reconvat_tpu_torch.data.loader import cycle, prefetch_to_device


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class _Batches:
    """A sized loader of host batches, each array filled from its own
    seed, with a path beside them."""

    def __init__(self, n, shape=(8, 327680)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def batch(self, i):
        rng = np.random.RandomState(i)
        return {"audio": rng.randn(*self.shape).astype(np.float32),
                "frame": (rng.rand(self.shape[0], 640, 88) < 0.03).astype(
                    np.float32), "path": f"batch{i}"}

    def __iter__(self):
        return (self.batch(i) for i in range(self.n))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 2, 4])
def test_prefetch_batches_arrive_intact(cuda_device, size):
    """Every batch equals its host source after the pinned asynchronous
    copies, while the consumer's stream is kept busy (so copies land
    while earlier batches are still in use, and the caching allocators
    are under pressure to reuse pinned and device memory), over three
    passes of a cycled loader."""
    source = _Batches(5)
    it = prefetch_to_device(cycle(source), cuda_device, size=size)
    busy = torch.randn(2048, 2048, device=cuda_device)
    for i in range(3 * len(source)):
        batch = next(it)
        for _ in range(4):
            busy = torch.tanh(busy @ busy) * 0.5
        total = batch["audio"].sum() + batch["frame"].sum()
        ref = source.batch(i % len(source))
        assert batch["path"] == ref["path"]
        for k in ("audio", "frame"):
            assert batch[k].device.type == "cuda"
            assert torch.equal(batch[k].cpu(), torch.from_numpy(ref[k])), k
        assert np.isclose(total.item(), ref["audio"].sum(dtype=np.float64)
                          + ref["frame"].sum(), rtol=1e-3)
    torch.cuda.synchronize()
