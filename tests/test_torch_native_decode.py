"""The port's native note decoder (`csrc/note_extract.cpp`, built by the
host compiler) against its numpy plain versions and against the JAX
package's decoder, on the CPU. Notes are compared exactly: both paths
threshold the same fp32 values with a strict `>` and walk the same
integer rolls.
"""
import numpy as np
import pytest
import torch

from reconvat_tpu import decode as jdecode
from reconvat_tpu_torch import decode
from reconvat_tpu_torch.kernels import _build
from reconvat_tpu_torch.models.common import pack_roll_device

KINDS = ("dense", "sparse", "empty", "full", "at_half", "t1")


def _roll(kind, P, B=1, seed=0):
    """(B, T, P) fp32 posteriogram of one kind."""
    rng = np.random.RandomState(seed)
    T = 1 if kind == "t1" else 40
    probs = rng.rand(B, T, P).astype(np.float32)
    if kind == "sparse":   # a few sustained notes, like a trained model
        probs = np.where(rng.rand(B, 1, P) < 0.1, probs, probs * 0.5)
    elif kind == "empty":
        probs[:] = 0.0
    elif kind == "full":
        probs[:] = 1.0
    elif kind == "at_half":  # exactly at the threshold: strict >
        probs[:, ::2] = 0.5
    return probs


def _assert_notes_equal(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a).reshape(-1),
                                      np.asarray(b).reshape(-1))
        assert np.asarray(a).size == np.asarray(b).size


@pytest.mark.parametrize("rule", ["rule1", "rule2"])
@pytest.mark.parametrize("P", [88, 13])
@pytest.mark.parametrize("kind", KINDS)
def test_float_rolls_match_plain_and_jax(kind, P, rule):
    on = _roll(kind, P, seed=1)[0]
    fr = _roll(kind, P, seed=2)[0]
    calls = decode.extract_notes_wo_velocity.calls
    got = decode.extract_notes_wo_velocity(on, fr, rule=rule)
    assert decode.extract_notes_wo_velocity.calls == calls + 1
    _assert_notes_equal(got, decode.extract_notes_wo_velocity_plain(
        on, fr, rule=rule))
    _assert_notes_equal(got, jdecode.extract_notes_wo_velocity(
        on, fr, rule=rule))
    # aliased onsets == frames, the ReconVAT transcribe contract
    _assert_notes_equal(decode.extract_notes_wo_velocity(on, on, rule=rule),
                        decode.extract_notes_wo_velocity_plain(on, on,
                                                               rule=rule))


@pytest.mark.parametrize("frames", ["aliased", "own"])
@pytest.mark.parametrize("rule", ["rule1", "rule2"])
@pytest.mark.parametrize("P", [88, 13])
@pytest.mark.parametrize("kind", KINDS)
def test_packed_batches_match_plain_and_jax(kind, P, rule, frames):
    """B = 3 packed rolls in one native call; frames_packed None decodes
    the onset roll as both (the C path that reads one roll)."""
    on = pack_roll_device(torch.from_numpy(_roll(kind, P, B=3, seed=3)))
    on = on.numpy()
    fr = (None if frames == "aliased" else pack_roll_device(
        torch.from_numpy(_roll(kind, P, B=3, seed=4))).numpy())
    calls = decode.extract_notes_packed_batch.calls
    got = decode.extract_notes_packed_batch(on, fr, n_pitches=P, rule=rule)
    assert decode.extract_notes_packed_batch.calls == calls + 1
    plain = decode.extract_notes_packed_batch_plain(on, fr, n_pitches=P,
                                                    rule=rule)
    ref = jdecode.extract_notes_packed_batch(on, fr, n_pitches=P, rule=rule)
    assert len(got) == len(plain) == len(ref) == 3
    for g, p, r in zip(got, plain, ref):
        _assert_notes_equal(g, p)
        _assert_notes_equal(g, r)


def test_packed_batch_notes_exist_and_rejects_bad_input():
    on = pack_roll_device(torch.from_numpy(_roll("dense", 88, B=3))).numpy()
    notes = decode.extract_notes_packed_batch(on)
    assert all(len(p) > 0 and len(p) == len(i) for p, i in notes)
    with pytest.raises(ValueError):
        decode.extract_notes_packed_batch(on[..., :5])
    with pytest.raises(ValueError):
        decode.extract_notes_packed_batch(np.zeros((1, 4, 17), np.uint8),
                                          n_pitches=136)
    with pytest.raises(NameError):
        decode.extract_notes_packed_batch(on, rule="rule3")
    with pytest.raises(ValueError):
        decode.extract_notes_wo_velocity(np.zeros((2, 3, 4)),
                                         np.zeros((2, 3, 4)))


def test_failed_build_raises_and_never_falls_back(monkeypatch):
    """A library that does not build raises with the compiler's message;
    the decode calls raise with it and do not fall back to numpy."""
    monkeypatch.setattr(_build, "HOST_FLAGS",
                        [*_build.HOST_FLAGS, "-fno-such-option-exists"])
    monkeypatch.setattr(_build, "_libs", {})
    roll = _roll("dense", 88)[0]
    with pytest.raises(RuntimeError, match="host compiler failed"):
        decode.extract_notes_wo_velocity(roll, roll)
    packed = pack_roll_device(torch.from_numpy(roll[None])).numpy()
    with pytest.raises(RuntimeError, match="no-such-option"):
        decode.extract_notes_packed_batch(packed)
