"""Shared signal-chain, bucketing and streaming helpers (PyTorch
counterpart of `reconvat_tpu/models/common.py:25-352`).

The bucketed path pads a clip to a frame-bucket boundary; the spectrogram
normalization statistics are masked to the true frames, and the caller
trims predictions to them. Outputs then differ from the exact path only
inside the network's receptive-field halo at the clip end. The streaming
path (`transcribe_streaming`) transcribes a song of any length in haloed
fixed-shape windows, with device memory bounded by the window.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C

# Doubling ladder of frame counts for full songs; longer songs extend it by
# further doubling.
BUCKET_LADDER = (640, 1280, 2560, 5120, 10240, 20480)


def next_bucket(t_true: int, ladder=BUCKET_LADDER) -> int:
    for b in ladder:
        if t_true <= b:
            return b
    b = ladder[-1]
    while b < t_true:
        b *= 2
    return b


def frames_in(n_samples: int) -> int:
    """Frame count of the signal chain for an n-sample clip (the chain drops
    the final sample: 327680 samples -> 640 frames, reference
    `model/self_attention_VAT.py:1112`)."""
    return (n_samples - 1) // C.HOP_LENGTH + 1


def frame_mask(t_true, n_frames: int, device=None) -> torch.Tensor:
    """Boolean (n_frames,) mask of the true (unpadded) frames; a (B,)
    tensor of per-row t_true gives a (B, n_frames) mask."""
    frames = torch.arange(n_frames, device=device)
    if torch.is_tensor(t_true) and t_true.dim() == 1:
        return frames[None] < t_true.to(device)[:, None]
    return frames < t_true


def make_log_spec(model, audio: torch.Tensor) -> torch.Tensor:
    """audio (B, N) float in [-1, 1] -> un-normalized log-spec (B, T, F):
    frontend on audio[:, :-1] (the chain drops the final sample) ->
    log(x + 1e-5)."""
    spec = model.frontend(audio[:, :-1])
    if model.log:
        spec = torch.log(spec + 1e-5)
    return spec


def make_log_norm_spec(model, audio, t_true=None) -> torch.Tensor:
    """audio (B, N) -> normalized log-spec (B, T, F); with t_true the
    normalization statistics cover only the true frames."""
    spec = make_log_spec(model, audio)
    mask = (None if t_true is None
            else frame_mask(t_true, spec.shape[1], spec.device))
    return model.normalize(spec, mask)


def pad_audio_to_frames(audio: torch.Tensor, t_pad: int) -> torch.Tensor:
    """Right-pad (B, N) audio so the signal chain yields exactly t_pad
    frames. The pad starts with a reflection of audio[:, :-1] (what the
    frontend's centre padding synthesizes there on the exact path, so frames
    below t_true match it), then zeros, then one trailing sample for the
    chain to drop."""
    n_pad = t_pad * C.HOP_LENGTH
    n = audio.shape[1]
    if n > n_pad:
        raise ValueError(f"{n} samples exceed {t_pad} frames")
    if n == n_pad:
        return audio
    x = audio[:, :-1]
    pad = (n_pad - 1) - x.shape[1]
    r = min(pad, x.shape[1] - 1)
    out = F.pad(x[:, None], (0, r), mode="reflect")[:, 0]
    return F.pad(out, (0, pad - r + 1))


def pad_song_batch(item, t_pad: int):
    """Host-side: full-song label dict -> batch-of-1 dict of numpy arrays
    padded to t_pad frames (counterpart of
    `reconvat_tpu/models/common.py:97`). Returns (batch, t_true)."""
    audio = np.asarray(item["audio"])
    if audio.ndim == 1:
        audio = audio[None]
    t_true = frames_in(audio.shape[1])
    if t_true > t_pad:
        raise ValueError(f"{t_true} frames exceed the bucket of {t_pad}")
    batch = {"audio": pad_audio_to_frames(torch.from_numpy(audio),
                                          t_pad).numpy()}
    for k in ("onset", "offset", "frame", "velocity"):
        if k in item:
            v = np.asarray(item[k])
            if v.ndim == 2:
                v = v[None]
            batch[k] = np.pad(v, ((0, 0), (0, t_pad - v.shape[1]), (0, 0)))
    return batch, t_true


def pack_roll_device(probs: torch.Tensor, threshold: float = 0.5):
    """Threshold a (B, T, P) posteriogram (strict > threshold) and bit-pack
    it on the device: bit j of byte k = pitch k*8+j (little bit order).
    Returns (B, T, ceil(P/8)) uint8."""
    B, T, P = probs.shape
    K = -(-P // 8)
    bits = (probs > threshold).to(torch.uint8)
    bits = F.pad(bits, (0, K * 8 - P)).reshape(B, T, K, 8)
    # shifts made on the device: a tensor built from a host list would be a
    # pageable copy, which waits for the stream and stalls the pipeline
    shifts = torch.arange(8, dtype=torch.uint8, device=probs.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.uint8)


def transcribe_spec(model, audio, bucket_frames: int = 0):
    """Serving-path spec preparation: returns (spec (B, T, F), t_true or
    None). bucket_frames > 0 pads the clip to a frame-bucket boundary; the
    caller trims the returned rolls to t_true. The frame mask runs over the
    spec's own frames, so CFP's T - 2 frames take it as the JAX package
    gives them."""
    if not bucket_frames:
        return make_log_norm_spec(model, audio), None
    t_true = frames_in(audio.shape[1])
    t_pad = -(-t_true // bucket_frames) * bucket_frames
    audio = pad_audio_to_frames(audio, t_pad)
    return make_log_norm_spec(model, audio, t_true), t_true


# ---------------------------------------------------------------------------
# streaming (bounded-memory) full-song transcription
# ---------------------------------------------------------------------------

def tree_map(fn, *trees):
    """fn over the leaves of a tensor (or array) or a dict of them."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _frame_slice_audio(audio, f0: int, f1: int, t_pad: int):
    """Audio samples whose signal chain reproduces frames [f0, f1) of the
    full song, right-padded like the bucketed path (reflect at the slice
    end, then zeros) to exactly t_pad frames. Frame t of the slice has the
    sample centre of frame f0 + t of the song, so interior frames are
    identical; only the ~2 frames nearest a cut edge see the slice's
    padding instead of true context, and they fall in the discarded
    halo."""
    n = audio.shape[1]
    s0, s1 = f0 * C.HOP_LENGTH, min(n, f1 * C.HOP_LENGTH)
    return pad_audio_to_frames(audio[:, s0:s1], t_pad)


def transcribe_streaming(model, forward, audio, window_frames: int = 640,
                         halo_frames: int = 128, windows_per_batch: int = 1,
                         mesh_ctx=None, pipeline_depth: int = 3):
    """Bounded-memory full-song transcription in haloed fixed-shape windows
    (counterpart of `reconvat_tpu/models/common.py:172-352`).

    audio (B, N) float in [-1, 1], moved to the model's device whole (the
    audio is small next to the activations); `forward(spec_image)` maps a
    (B', T, F, 1) normalized spec to a (B', T, P) roll, or to a dict of
    such rolls (UNetOnset's {"onset", "frame"}). Returns the (B, t_true,
    P) fp32 roll on the host, or the dict of them.

    1. `imagewise` normalization needs the song-global log-spec min/max:
       pass 1 reduces them over spectrogram chunks of W frames with an
       edge halo of E frames, the frontend's reach (`frame_reach`) plus
       the frames it drops at the start (`frame_offset`): Mel 4, CQT 32,
       CFP 5 (only the chunk's own frames count, so the statistics equal
       the full song's). The reductions stay on the device: no chunk
       waits for the host.
    2. pass 2 runs windows of W + 2H frames (H frames of real context per
       side), normalized by the global statistics, and keeps each
       window's W interior frames. `windows_per_batch` = G windows are
       stacked into one forward (leading axis G*B; the last group is
       filled with copies of the last window, whose outputs are dropped);
       up to `pipeline_depth` groups are in flight, each group's rolls
       copied to pinned host memory on a side stream (CUDA) while later
       groups run. Output is identical for any depth.

    A slice's spec frame i is the song's frame f0 + i for every frontend:
    CFP drops the first frame of the slice as it drops the song's, so its
    offset moves the frames a spec frame reads (the halo E above), not the
    map. The roll has the bucketed roll's frames: t_true, of which CFP's
    last two lie past the audio, as the bucketed path's do.

    Interior outputs equal the full-song path wherever the halo covers the
    transcriber's receptive field. W and H must be multiples of 16 (the
    U-Net's total stride, which keeps every window's strided grids
    anchored like the full song's) and H at least 8 and E (the
    spectrogram's edge frames). A song of at most W + 2H frames is one
    bucketed call padded to that span.

    `mesh_ctx` (a `parallel.mesh.MeshContext` over the started process
    group; every rank calls with the same song) deals pass 2's window
    groups out to the ranks: rank r runs groups r, r + world, ... (each
    the stack of windows one device would run). Every rank reads all of
    pass 1's chunks (the mel is a small share of a window's work, and
    each rank then holds the one device's statistics bit for bit, with
    no collective), and the rolls are gathered by one zero-fill
    all-reduce of the whole (B, t_true, P) roll on the rank's device
    (each frame is written by one rank and zero on the others, so the sum
    is exact): every rank returns one device's roll. A song of at most
    W + 2H frames runs whole on every rank.
    """
    W, H = int(window_frames), int(halo_frames)
    E = model.frontend.frame_reach + model.frontend.frame_offset
    if H < max(8, E):
        raise ValueError(f"halo_frames {H} < {max(8, E)} does not cover the "
                         f"spectrogram edge frames (the "
                         f"{type(model.frontend).__name__} frontend reaches "
                         f"{E} frames)")
    if W % 16 or H % 16:
        raise ValueError(f"window_frames {W} and halo_frames {H} must be "
                         f"multiples of 16 (the U-Net's total stride)")
    device = model.device
    audio = torch.as_tensor(audio, dtype=torch.float32).to(device)
    B, n = audio.shape
    t_true = frames_in(n)
    span = W + 2 * H

    if t_true <= span:  # short clip: one bucketed call is already bounded
        spec = make_log_norm_spec(model, pad_audio_to_frames(audio, span),
                                  t_true)
        return tree_map(lambda r: r[:, :t_true].float().cpu(),
                         forward(spec[..., None]))

    G = max(1, int(windows_per_batch))
    imagewise = model.normalize.mode == "imagewise"
    if imagewise:  # pass 1: song-global statistics
        mins, maxs = [], []
        for w0 in range(0, t_true, W):
            w1 = min(t_true, w0 + W)
            f0, f1 = max(0, w0 - E), min(t_true, w1 + E)
            chunk = make_log_spec(
                model, _frame_slice_audio(audio, f0, f1, W + 2 * E))
            keep = chunk[:, w0 - f0:w1 - f0]
            mins.append(keep.amin(dim=(1, 2)))     # per batch element
            maxs.append(keep.amax(dim=(1, 2)))
        # (G*B, 1, 1) in the g*B + b order of the stacked windows
        lo = torch.stack(mins).amin(0).reshape(B, 1, 1).repeat(G, 1, 1)
        hi = torch.stack(maxs).amax(0).reshape(B, 1, 1).repeat(G, 1, 1)

    starts = list(range(0, t_true, W))
    n_real = len(starts)
    while len(starts) % G:
        starts.append(starts[-1])
    # the first window of each group this rank runs; a rank left without
    # one runs the first and keeps zeros (the gather's shapes)
    rank, world = ((mesh_ctx.rank, mesh_ctx.world) if mesh_ctx is not None
                   else (0, 1))
    mine = list(range(0, len(starts), G))[rank::world]
    idle = not mine
    mine = mine or [0]
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def dispatch(gi):
        """Enqueue window group gi; returns (gi, its starts, its rolls (on
        the host once `done` has completed), done event or None)."""
        group = starts[gi:gi + G]
        # f0 = w0 - H keeps every window's stride-2 grids anchored like the
        # full song's; the last window's slice runs past the song end and
        # pads like the bucketed path
        aa = torch.stack([_frame_slice_audio(
            audio, max(0, w0 - H), max(0, w0 - H) + span, span)
            for w0 in group]).reshape(G * B, -1)
        spec = make_log_spec(model, aa)
        spec = (spec - lo) / (hi - lo) if imagewise else model.normalize(spec)
        rolls = tree_map(lambda r: r.float(), forward(spec[..., None]))
        if copy_stream is None:
            return gi, group, rolls, None
        copy_stream.wait_stream(torch.cuda.current_stream(device))

        def to_host(roll):
            host = torch.empty(roll.shape, dtype=roll.dtype,
                               pin_memory=True)
            host.copy_(roll, non_blocking=True)
            roll.record_stream(copy_stream)
            return host

        with torch.cuda.stream(copy_stream):
            host = tree_map(to_host, rolls)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return gi, group, host, done

    out = None
    depth = max(1, int(pipeline_depth))
    pending, nxt = [], 0
    while nxt < len(mine) or pending:
        while nxt < len(mine) and len(pending) < depth:
            pending.append(dispatch(mine[nxt]))
            nxt += 1
        gi, group, rolls, done = pending.pop(0)
        if done is not None:
            done.synchronize()   # the pinned buffers are read only after this
        rolls = tree_map(lambda roll: roll.numpy().reshape(
            (G, B) + tuple(roll.shape[1:])), rolls)
        if out is None:
            out = tree_map(lambda r: np.zeros((B, t_true) + r.shape[3:],
                                               np.float32), rolls)
        for i, w0 in enumerate(group):
            if gi + i >= n_real:
                break
            w1, f0 = min(t_true, w0 + W), max(0, w0 - H)

            def put(dst, r):
                dst[:, w0:w1] = r[i][:, w0 - f0:w1 - f0]

            tree_map(put, out, rolls)
    if world == 1:
        return tree_map(torch.from_numpy, out)
    if idle:
        out = tree_map(np.zeros_like, out)
    return tree_map(lambda r: _gather_roll(r, mesh_ctx), out)


def _gather_roll(roll, ctx):
    """The sum over the ranks of `roll` (numpy, zero where this rank ran no
    window), on the host."""
    import torch.distributed as dist

    t = torch.from_numpy(roll).to(ctx.device)
    dist.all_reduce(t)
    return t.cpu()
