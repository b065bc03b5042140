"""Training loops and TensorBoard logging (the port's counterpart of
`reconvat_tpu/train/loop.py`, reference `train_VAT_model` /
`train_model` / `eval_model` / `tensorboard_log`,
`model/helper_functions.py:120-687`): per-"epoch" `iteration` steps drawn
from cycled labeled and unlabeled loaders, per-epoch scalar logging and
periodic evaluation, with the reference's tags.

The TensorBoard event files are written by hand (`EventWriter`: TFRecord
framing with masked CRC-32C around `Event` protocol buffers), as the
`tensorboard` package is not a dependency of the port.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from collections import defaultdict, deque

import numpy as np
import torch

from ..data.loader import BATCH_KEYS, device_batch
from ..evaluate import _eval_forward, evaluate_wo_velocity, metric_parts
from ..models.reconvat import fp32_math
from ..utils import png_bytes
from . import profiler


def _host_total(host_losses):
    """`total_loss_from_dict(..., 1.0)` of host scalars."""
    if "loss/total" in host_losses:
        return float(host_losses["loss/total"])
    return sum(float(v) / 2.0 if k.startswith("loss/train_LDS")
               else float(v) for k, v in host_losses.items())


def _host_scalars(losses) -> dict:
    """{key: float} of a dict of device scalars, read back in one copy."""
    keys = list(losses)
    if not keys:
        return {}
    values = torch.stack([torch.as_tensor(losses[k]).float() for k in keys])
    return dict(zip(keys, values.cpu().tolist()))


def strip_total(losses):
    """The step's losses without its accounting scalar, so TensorBoard
    carries exactly the reference's keys."""
    return {k: v for k, v in losses.items() if k != "loss/total"}


class _StepDrain:
    """Deferred host readback of each step's losses.

    A step's device scalars are read back only after `depth` further steps
    have been launched, so the host launches step i+1 (and the loader
    stages batch i+2) while step i runs; one `.cpu()` of the stacked
    scalars per step. The totals are the same at any depth; only the
    moment of the readback moves (the NaN guard and the progress line
    trail by `depth` steps). depth 0 is the reference's synchronous loop.
    """

    def __init__(self, depth, timer, check_nans, on_step=None):
        self.depth = max(0, int(depth))
        self.timer = timer
        self.check_nans = check_nans
        self.on_step = on_step
        self.total_loss = 0.0
        self._pending = deque()

    def push(self, i, losses):
        self._pending.append((i, losses))
        while len(self._pending) > self.depth:
            self._drain_one()

    def flush(self):
        while self._pending:
            self._drain_one()
        return self.total_loss

    def _drain_one(self):
        i, losses = self._pending.popleft()
        host = _host_scalars(losses)
        self.total_loss += _host_total(host)
        if self.timer is not None:
            self.timer.tick()
        if self.check_nans:
            profiler.nan_guard(host, "loss")
        if self.on_step is not None:
            self.on_step(i, host)


def train_VAT_model(model, state, train_step, iteration, ep, l_iter, ul_iter,
                    generator, vat=False, vat_start=0, verbose=True,
                    timer=None, pipeline=1):
    """One "epoch" = `iteration` optimizer steps, in place on the model and
    `state`; returns the last step's losses (device scalars).
    `train_step[use_vat]` is the step; the batches come from the device
    iterators l_iter and ul_iter (None without unlabeled data); the VAT
    directions from `generator`. `pipeline` steps stay in flight before
    their losses are read back (`_StepDrain`)."""
    losses = {}

    def show(i, step_losses):
        if verbose:
            main = sum(v for k, v in step_losses.items()
                       if k != "loss/total")
            print(f"Train Epoch: {ep} [{i}/{iteration}] "
                  f"Main Loss: {main:.6f}", end="\r")

    drain = _StepDrain(pipeline, timer, profiler.nan_checks_enabled(),
                       on_step=show)
    use_vat = vat and ep >= vat_start
    for i in range(iteration):
        batch_l = device_batch(next(l_iter))
        batch_ul = (device_batch(next(ul_iter))
                    if ul_iter is not None and use_vat else batch_l)
        losses = train_step[bool(use_vat)](state, batch_l, batch_ul,
                                           generator)
        drain.push(i, losses)
    total_loss = drain.flush()
    if verbose:
        print(" " * 100, end="\r")
        msg = f"Train Epoch: {ep}\tLoss: {total_loss / iteration:.6f}"
        if timer is not None and timer.step_time:
            msg += f"\t({timer.summary()})"
        print(msg)
    return strip_total(losses)


def train_model(model, state, train_step, ep, loader, generator,
                verbose=True, timer=None, pipeline=1):
    """Full-epoch supervised sweep over a host loader (reference
    `train_model`, `model/helper_functions.py:542-568`), in place;
    returns the last step's losses."""
    losses = {}
    n = 0

    def show(i, step_losses):
        if verbose:
            print(f"Train Epoch: {ep} [{i + 1}]", end="\r")

    drain = _StepDrain(pipeline, timer, profiler.nan_checks_enabled(),
                       on_step=show)
    for batch in loader:
        b = _to_device(device_batch(batch), model.device)
        losses = train_step(state, b, b, generator)
        drain.push(n, losses)
        n += 1
    total_loss = drain.flush()
    if verbose:
        print(" " * 100, end="\r")
        print(f"Train Epoch: {ep}\tLoss: {total_loss / max(n, 1):.6f}")
    return strip_total(losses)


def _to_device(batch, device):
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
            .to(device) for k, v in batch.items()}


def eval_model(model, eval_step, ep, loader, generator=None, verbose=False,
               pipeline=1):
    """Reference `eval_model` (`model/helper_functions.py:667-687`): the
    eval-mode losses of every batch of a host loader, {key: [floats]}."""
    metrics = defaultdict(list)
    pending = deque()
    depth = max(0, int(pipeline))

    def drain_one():
        i, losses = pending.popleft()
        for k, v in _host_scalars(losses).items():
            metrics[k].append(v)
        if verbose:
            print(f"Eval Epoch: {ep} [{i}]", end="\r")

    for i, batch in enumerate(loader):
        pending.append((i, eval_step(
            _to_device(device_batch(batch), model.device), generator)))
        while len(pending) > depth:
            drain_one()
    while pending:
        drain_one()
    return metrics


def flatten_attention(a, w_size=31):
    """Unroll a banded attention map (L, window) to a dense (L, L) image
    for visualization (reference `flatten_attention`,
    `model/helper_functions.py:527-540`)."""
    a = np.asarray(a)
    hw = (w_size - 1) // 2
    L = a.shape[0]
    out = np.zeros((L, L), dtype=a.dtype)
    for t in range(L):
        start = 0 if t - hw < 0 else t - hw
        end = L if t + hw > L else t + hw
        if t < hw:
            out[t, start:end + 1] = a[t, -(end - start) - 1:]
        else:
            out[t, start:end] = a[t, :(end - start)]
    return out


# -- TensorBoard event files -------------------------------------------------

def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def _masked_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protocol-buffer field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


class EventWriter:
    """Appends `Event` records to `logdir/events.out.tfevents.*`, the file
    TensorBoard reads: Event{wall_time = 1, step = 2, file_version = 3,
    summary = 5}; Summary{value = 1}; Value{tag = 1, simple_value = 2,
    image = 4}; Image{height = 1, width = 2, colorspace = 3,
    encoded_image_string = 4}."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.0")
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "wb")
        self._event(0, _field(3, b"brain.Event:2"))

    def _event(self, step: int, body: bytes) -> None:
        data = (b"\x09" + struct.pack("<d", time.time())
                + b"\x10" + _varint(step & 0xFFFFFFFFFFFFFFFF) + body)
        header = struct.pack("<Q", len(data))
        self._file.write(header + struct.pack("<I", _masked_crc32c(header))
                         + data + struct.pack("<I", _masked_crc32c(data)))

    def _summary(self, step, tag, value: bytes) -> None:
        self._event(step, _field(5, _field(1, _field(1, tag.encode())
                                           + value)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._summary(step, tag, b"\x15" + struct.pack("<f", value))

    def image(self, tag: str, image, step: int) -> None:
        """uint8 (H, W) grayscale or (H, W, 3) RGB image, as a PNG."""
        image = np.asarray(image)
        h, w = image.shape[:2]
        colors = 1 if image.ndim == 2 else 3
        msg = (b"\x08" + _varint(h) + b"\x10" + _varint(w) + b"\x18"
               + _varint(colors) + _field(4, png_bytes(image)))
        self._summary(step, tag, _field(4, msg))

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.close()


def _gray(arr):
    """A 2-D array as an 8-bit image: transposed (the second axis
    vertical, its first entry at the bottom) and min-max scaled."""
    a = np.asarray(arr, dtype=np.float64).T[::-1]
    lo, hi = np.nanmin(a), np.nanmax(a)
    scaled = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    return np.round(np.nan_to_num(scaled) * 255).astype(np.uint8)


class NullLogger:
    """A logger that writes nothing."""

    def add_scalar(self, key, value, step):
        pass

    def log_losses(self, losses, step):
        pass

    def log_images(self, tag, arrays, step, cmap="jet"):
        pass

    def close(self):
        pass


class TensorboardLogger:
    """Scalars and images with the reference's tags, in an event file
    under `logdir`. Each array of `log_images` is one grayscale PNG image
    summary under the tag (the JAX package draws them as one matplotlib
    figure with colour maps; neither its layout nor its colour maps are
    reproduced)."""

    def __init__(self, logdir):
        self.writer = EventWriter(logdir)

    def add_scalar(self, key, value, step):
        self.writer.scalar(key, float(value), step)

    def log_losses(self, losses, step):
        for key, value in _host_scalars(losses).items():
            self.writer.scalar(key, value, step)
        self.writer.flush()

    def log_images(self, tag, arrays, step, cmap="jet"):
        for arr in arrays:
            self.writer.image(tag, _gray(arr), step)
        self.writer.flush()

    def close(self):
        self.writer.close()


def _host(x):
    return x.detach().float().cpu().numpy()


def tensorboard_log(logger, model, batch_visualize, validation_set,
                    supervised_loader, eval_step, ep, logging_freq,
                    generator, vat, vat_start, reconstruction,
                    verbose=True):
    """Periodic logging as reference `tensorboard_log`
    (`model/helper_functions.py:120-275`): an eval-mode pass over
    `batch_visualize` (a device batch; VAT from epoch `vat_start`), every
    `logging_freq` epochs and at epoch 1 the validation metrics and the
    supervised loader's eval losses, images at epoch 1 and every
    `logging_freq` epochs. Returns the pass's losses."""
    use_vat = vat and ep >= vat_start
    with torch.set_grad_enabled(use_vat), fp32_math():
        preds, losses, mel = model.run_on_batch(
            batch_visualize, None, generator, vat=use_vat, train=False)

    if ep % logging_freq == 0 or ep == 1:
        def runner(item):
            batch = {k: (np.asarray(v)[None] if k in BATCH_KEYS
                         and np.asarray(v).ndim in (1, 2) else v)
                     for k, v in item.items()}
            return _eval_forward(model, batch, None)

        results = evaluate_wo_velocity(validation_set, runner,
                                       reconstruction=reconstruction)
        for k, values in results.items():
            if metric_parts(k):
                category, name = metric_parts(k)
                if verbose:
                    print(f"{category:>32} {name:25}: "
                          f"{np.mean(values):.3f} ± {np.std(values):.3f}")
                if (("precision" in name or "recall" in name
                     or "f1" in name) and "chroma" not in name):
                    logger.add_scalar(k, float(np.mean(values)), ep)
        test_losses = eval_model(model, eval_step, ep, supervised_loader,
                                 generator)
        for k, values in test_losses.items():
            if k.startswith("loss/"):
                logger.add_scalar(k, float(np.mean(values)), ep)

    if ep == 1:
        logger.log_images("images/Original", _host(mel), ep)
        logger.log_images("images/Label", _host(batch_visualize["frame"]),
                          ep, cmap=None)

    if ep % logging_freq == 0:
        for out_key in ["frame", "onset", "frame2", "onset2"]:
            if preds.get(out_key) is not None:
                logger.log_images(f"images/{out_key}", _host(preds[out_key]),
                                  ep, cmap=None)
        if preds.get("reconstruction") is not None:
            logger.log_images("images/Reconstruction",
                              _host(preds["reconstruction"])[..., 0], ep)
        if preds.get("r_adv") is not None:
            logger.log_images("images/Spec_adv",
                              _host(mel) + _host(preds["r_adv"]), ep)
        if preds.get("attention") is not None:
            attn = _host(preds["attention"])   # (B, L, heads, window)
            w = attn.shape[-1]
            maps = [flatten_attention(attn[0, :, h], w)
                    for h in range(attn.shape[2])]
            logger.log_images("images/Attention", maps, ep)
    return losses
