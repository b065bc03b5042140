"""Carry a JAX variable tree of the reference package into the port.

`flax_to_torch` is the inverse of `reconvat_tpu/train/torch_convert.py`:
the port keeps the reference submodule names, so conversion is name for
name with a layout change per leaf:

  conv kernel (kh, kw, I, O)            -> weight (O, I, kh, kw)
  conv-transpose kernel (kh, kw, O, I)  -> weight (I, O, kh, kw)
  Dense kernel (I, O)                   -> weight (O, I)
  BatchNorm scale / bias                -> weight / bias
  batch_stats mean / var                -> running_mean / running_var
  rel, rel_t, rel_f                     -> the same (as is; Segmentation's
                                           2-D attention keeps the
                                           reference's 5-D shapes)

Both 4-D cases are the same axis permutation (3, 2, 0, 1), but for
Thickstun's `CNN_freq` and `CNN_time`: the reference's weights are
(O, I, freq, time) and the JAX kernels (time, freq, I, O), so (3, 2, 1, 0)
(`reconvat_tpu/models/thickstun.py:126-137`).

The families whose JAX modules are named otherwise than the reference's
get the reference's names back, the inverse of the JAX package's loaders.
A BiLSTM's leaves are renamed wherever they sit:
  - `{fwd,bwd}_w_ih`, `_w_hh` (F or H, 4H) and `_bias` (4H) ->
    `weight_ih_l0[_reverse]`, `weight_hh_l0[_reverse]` (transposed; the
    gate order i, f, g, o is torch's), `bias_ih_l0[_reverse]` = the fused
    bias and `bias_hh_l0[_reverse]` = 0.
Module names are renamed only where `target` (the port module the result
is for, or its state_dict keys) holds leaves under the new path and none
under the JAX one (`_torch_path`); without `target` no module is renamed:
  - the O&F conv trunk's `conv0/bn0/conv1/bn1/conv2/bn2/fc` -> `cnn.0/1/3/
    4/8/9`, `fc.0` (the O&F family's stacks, the attention models'
    ConvStack `cnn`, `onset_conv`, `frame_conv`; a Timbral CNN keeps the
    JAX names);
  - the O&F family's `frame_conv` / `frame_linear` -> `frame_stack.0` /
    `.1` (`reconvat_tpu/models/onsets_frames.py:205-219`);
  - Prestack's `Unet1_*` -> `prestack_model.0.Unet1_*`, `resnet` ->
    `prestack_model.1`, and Flax's list names `layer1_0`, `downsample_0`
    -> `layer1.0`, `downsample.0` (`reconvat_tpu/models/prestack.py:
    198-224`).
"""
from __future__ import annotations

import itertools
import re
from collections import OrderedDict

import numpy as np
import torch


def _walk(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


_CONVSTACK = {"conv0": "cnn.0", "bn0": "cnn.1", "conv1": "cnn.3",
              "bn1": "cnn.4", "conv2": "cnn.8", "bn2": "cnn.9", "fc": "fc.0"}
_FREQ_MAJOR = {("CNN_freq",), ("CNN_time",)}      # Thickstun's convolutions
_LSTM_LEAF = re.compile(r"(fwd|bwd)_(w_ih|w_hh|bias)$")


def _renames(seg):
    """The reference's names that a JAX module name may stand for."""
    out = []
    if seg in _CONVSTACK:
        out.append(_CONVSTACK[seg])
    if seg in ("frame_conv", "frame_linear"):
        out.append("frame_stack." + ("0" if seg == "frame_conv" else "1"))
    if seg.startswith("Unet1_"):
        out.append("prestack_model.0." + seg)
    if seg == "resnet":
        out.append("prestack_model.1")
    out.append(re.sub(r"^(\w+)_(\d+)$", r"\1.\2", seg))
    return out


def _module_paths(target):
    """The module paths (dotted) that hold the leaves of `target`, a module
    or an iterable of state_dict keys."""
    keys = target.state_dict() if hasattr(target, "state_dict") else target
    return {key.rpartition(".")[0] for key in keys}


def _torch_path(path, modules) -> str:
    """The reference's module path (dotted) of a JAX module path: its JAX
    names, unless `modules` (`_module_paths` of the target, or None) lacks
    that path and has one with some segments replaced by their
    `_renames`."""
    options = [dict.fromkeys((seg, *_renames(seg))) for seg in path]
    names = [".".join(c) for c in itertools.product(*options)]
    return next((n for n in names if modules is not None and n in modules),
                names[0])


def _tensor(w):
    return torch.tensor(np.asarray(w, dtype=np.float32))


def flax_to_torch(variables,
                  target=None) -> "OrderedDict[str, torch.Tensor]":
    """{"params": ..., "batch_stats": ...} (nested dicts of arrays) ->
    a state_dict that `target` (the port module, or its state_dict keys)
    loads with strict=True; without `target`, no module is renamed."""
    params = variables["params"]
    modules = None if target is None else _module_paths(target)

    def _key(path, name):
        mod = _torch_path(path, modules)
        return f"{mod}.{name}" if mod else name

    sd = OrderedDict()
    for path, w in _walk(params):
        mod, leaf = path[:-1], path[-1]
        lstm = _LSTM_LEAF.match(leaf)
        if lstm:
            sfx = "_l0" + ("" if lstm.group(1) == "fwd" else "_reverse")
            if lstm.group(2) == "bias":
                sd[_key(mod, "bias_ih" + sfx)] = _tensor(w)
                sd[_key(mod, "bias_hh" + sfx)] = _tensor(np.zeros_like(w))
            else:
                sd[_key(mod, f"weight_{lstm.group(2)[2:]}{sfx}")] = \
                    _tensor(w.T)
            continue
        if leaf == "kernel":
            if w.ndim == 4:
                w = w.transpose((3, 2, 1, 0) if mod in _FREQ_MAJOR
                                else (3, 2, 0, 1))
            elif w.ndim == 2:
                w = w.T
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            name = "weight"
        elif leaf == "scale":
            name = "weight"
        elif leaf in ("bias", "rel", "rel_t", "rel_f"):
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
