"""Port's device bit-packing and host note decode vs the JAX package, on
the CPU. Packed rolls and decoded notes are compared exactly. The serving
path end to end is tested in tests/test_torch_reconvat.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reconvat_tpu import decode as jdecode
from reconvat_tpu.models.common import pack_roll_device as jax_pack
from reconvat_tpu_torch import decode as tdecode
from reconvat_tpu_torch.models.common import pack_roll_device

def _roll(B=3, T=50, P=88, density=0.1, seed=0):
    rng = np.random.RandomState(seed)
    probs = rng.rand(B, T, P).astype(np.float32)
    # sparse, with sustained notes, like a trained model's output
    probs = np.where(rng.rand(B, 1, P) < density * 3, probs, probs * 0.5)
    probs[:, :, 5] = 0.5                 # exactly at threshold: strict >
    return probs


@pytest.mark.parametrize("P", [88, 13])
def test_pack_roll_matches_jax(P):
    probs = _roll(P=P)
    ref = np.asarray(jax_pack(jnp.asarray(probs)))
    got = pack_roll_device(torch.from_numpy(probs))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tdecode.unpack_roll(got.numpy(), P),
                                  probs > 0.5)


@pytest.mark.parametrize("rule", ["rule1", "rule2"])
def test_extract_notes_matches_jax(rule):
    on, fr = _roll(B=1, seed=1)[0], _roll(B=1, seed=2)[0]
    ref = jdecode.extract_notes_wo_velocity(on, fr, rule=rule)
    got = tdecode.extract_notes_wo_velocity(on, fr, rule=rule)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_extract_notes_packed_batch_matches_jax():
    packed = pack_roll_device(torch.from_numpy(_roll(seed=3))).numpy()
    ref = jdecode.extract_notes_packed_batch(packed, rule="rule2")
    got = tdecode.extract_notes_packed_batch(packed, rule="rule2")
    assert len(got) == len(ref) == 3
    assert sum(len(p) for p, _ in got) > 0
    for (gp, gi), (rp, ri) in zip(got, ref):
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_array_equal(np.asarray(gi).reshape(-1, 2),
                                      np.asarray(ri).reshape(-1, 2))
    with pytest.raises(ValueError):
        tdecode.extract_notes_packed_batch(packed[..., :5])
