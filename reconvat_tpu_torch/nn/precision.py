"""Mixed precision as the JAX package runs it (`compute_dtype`, flax
`promote_dtype`): a layer given a compute dtype casts its input, weight and
bias to that dtype and returns its output in it, while its parameters stay
fp32. None keeps the layer in the dtype of its input and parameters (fp32).

The model's constructor takes the name (`resolve_compute_dtype`); the
layers under it take the torch dtype it resolves to.
"""
from __future__ import annotations

import torch


def resolve_compute_dtype(compute_dtype):
    """None (fp32) or torch.bfloat16, from None or 'bfloat16'; the port's
    kernels take no other operand type."""
    if compute_dtype is None:
        return None
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be None or 'bfloat16', got "
                     f"{compute_dtype!r}")


def cast(dtype, *tensors):
    """The tensors cast to `dtype`; None (tensor or dtype) passes through."""
    return tuple(t if dtype is None or t is None else t.to(dtype)
                 for t in tensors)


def promote_fp32(x):
    """x promoted to at least fp32 (flax `promote_dtype` with a fp32
    parameter): bf16 to fp32; fp32 and float64 unchanged."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
