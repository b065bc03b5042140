"""Carry a JAX variable tree of the reference package into the port.

`flax_to_torch` is the inverse of `reconvat_tpu/train/torch_convert.py`:
the port keeps the reference submodule names, so conversion is name for
name with a layout change per leaf:

  conv kernel (kh, kw, I, O)            -> weight (O, I, kh, kw)
  conv-transpose kernel (kh, kw, O, I)  -> weight (I, O, kh, kw)
  Dense kernel (I, O)                   -> weight (O, I)
  BatchNorm scale / bias                -> weight / bias
  batch_stats mean / var                -> running_mean / running_var
  rel                                   -> rel (as is)

Both 4-D cases are the same axis permutation (3, 2, 0, 1).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _walk(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _key(path, name):
    return ".".join((*path, name))


def _tensor(w):
    return torch.tensor(np.asarray(w, dtype=np.float32))


def flax_to_torch(variables) -> "OrderedDict[str, torch.Tensor]":
    """{"params": ..., "batch_stats": ...} (nested dicts of arrays) ->
    a state_dict that the port's modules load with strict=True."""
    sd = OrderedDict()
    for path, w in _walk(variables["params"]):
        mod, leaf = path[:-1], path[-1]
        if leaf == "kernel":
            if w.ndim == 4:
                w = w.transpose(3, 2, 0, 1)
            elif w.ndim == 2:
                w = w.T
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf in ("bias", "rel"):
            name = leaf
        else:
            raise ValueError(f"unknown parameter {'.'.join(path)}")
        sd[_key(mod, name)] = _tensor(w)
    for path, w in _walk(variables.get("batch_stats", {})):
        mod, leaf = path[:-1], path[-1]
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[_key(mod, name)] = _tensor(w)
        if leaf == "mean":
            sd[_key(mod, "num_batches_tracked")] = torch.tensor(0)
    return sd
