"""The port does all that the JAX package does: a walk over both packages'
public API (`api_gaps`).

For every module of `reconvat_tpu` (`pkgutil.walk_packages`), the module
of the same dotted name under `reconvat_tpu_torch` imports; every public
class and function defined in the JAX module has a namesake there; and
every parameter of the JAX constructor or function is a parameter of the
port's counterpart, under its own name or under the name `RENAMED` gives
it. Each exception is listed below with the reason it is not a gap:
JAX_ONLY_MODULES and JAX_ONLY_NAMES by dotted name, JAX_ONLY_PARAMS per
class or function, JAX_ONLY_ANYWHERE for parameters that mean the same
JAX-only thing wherever they appear. An exception that no longer
excuses anything (the JAX name is gone, or the port now has it) is
reported too, so the lists stay true.

Methods are not walked: a class's calls are held by the family tests.
The walker is held against a planted gap in a pair of small packages
written under `tmp_path` (`test_walker_reports_a_planted_gap`).
"""
import importlib
import inspect
import pkgutil
import textwrap

import reconvat_tpu

FOLDED = ("the frequency-folded TPU lane-tiling layout, not ported "
          "(ROADMAP port rules; the port runs the NHWC path)")
FLAX_NET = "the flax network under the dataclass; the port's is {}"
N_HEADS = ("metadata for the JAX package's attention plots "
           "(`reconvat_tpu/models/reconvat.py:164`); nothing reads it")

JAX_ONLY_MODULES = {
    "ops.pallas_mel": "the Pallas TPU mel kernel; the port's is "
                      "ops/mel_kernel.py (csrc/mel.cu)",
    "ops.pallas_attention": "the Pallas TPU attention forward; the port's "
                            "is ops/banded_attention_kernel.py "
                            "(csrc/banded_attention.cu)",
    "ops.pallas_attention_bwd": "the Pallas TPU attention backward; the "
                                "port's is ops/banded_attention_kernel.py "
                                "(csrc/banded_attention_bwd.cu)",
    "runtime": "TPU device set-up and XLA's compile cache; the port "
               "builds its kernels into build/kernels/",
    "train.torch_convert": "torch state_dict -> flax tree; "
                           "reconvat_tpu_torch/weights.py is its inverse",
}

JAX_ONLY_NAMES = {
    "models.onsets_frames.OnsetsAndFramesModule":
        FLAX_NET.format("OnsetsAndFramesNet"),
    "models.onsets_frames.FrameStackModule":
        FLAX_NET.format("FrameStackNet"),
    "models.onsets_frames.OnsetStackModule":
        FLAX_NET.format("OnsetStackNet"),
    "models.prestack.PrestackModule": FLAX_NET.format("PrestackNet"),
    "models.thickstun.ThickstunModule": FLAX_NET.format("ThickstunNet"),
    "models.unet_onset.UNetOnsetModule": FLAX_NET.format("OnsetUNet"),
    "models.segmentation.resolve_seg_layout": "picks " + FOLDED,
    "models.segmentation.seg_fold_specs": FOLDED,
    "nn.unet.resolve_conv_layout": "picks " + FOLDED,
    "nn.unet.FoldSpec": FOLDED,
    "nn.unet.unet_fold_specs": FOLDED,
    "nn.unet.unfold_channels": FOLDED,
    "nn.unet.fold_conv_kernel": FOLDED,
    "nn.unet.fold_convT_kernel": FOLDED,
    "nn.unet.refold": FOLDED,
    "nn.unet.fold_concat": FOLDED,
    "nn.unet.MaskedBatchNorm": "the folded layout's BatchNorm; " + FOLDED,
    "nn.unet.TorchConv": "a flax convolution with torch's padding and "
                         "init; the port uses nn/unet.py's Conv2d",
    "nn.unet.TorchConvTranspose": "likewise; the port uses nn/unet.py's "
                                  "ConvTranspose2d",
    "nn.attention.resolve_attn_impl": "picks the Pallas or XLA route on a "
                                      "TPU; the port's is `use_kernel`",
    "nn.layers.lstm_torch_entries": "torch LSTM -> flax leaves; "
                                    "weights.py converts the other way",
    "ops.spectrogram.frontend_precision": "a TPU matmul-precision switch; "
                                          "the port's frontends run fp32 "
                                          "with TF32 off",
    "parallel.mesh.make_multihost_mesh": "meshes across hosts "
                                         "(ROADMAP 'Later' C.2)",
    "parallel.mesh.spec_constraint": "a jax sharding constraint; each "
                                     "rank holds its rows "
                                     "(parallel.mesh.shard_batch)",
    "utils.cycle": "moved to data/loader.py (cycle)",
}

# parameters that mean the same JAX-only thing wherever they appear
JAX_ONLY_ANYWHERE = {
    "parent": "flax's module tree; a torch module holds its children",
    "name": "flax's module name; torch names a child by its attribute",
    "precision": "a TPU matmul-precision switch; the port runs fp32 with "
                 "TF32 off",
    "key": "a JAX PRNG key; the port draws from a torch.Generator "
           "(`generator`) or the model's `seed`",
    "state": "the JAX package's functional state; the port's model holds "
             "its weights and statistics",
    "attn_impl": "picks the Pallas or XLA attention on a TPU; the port's "
                 "route is `use_kernels`",
    "attn_block_size": "the Pallas kernel's block; the port's kernels tile "
                       "themselves",
    "block_size": "the Pallas or XLA attention's block; likewise",
    "conv_layout": "picks " + FOLDED,
    "layout": FOLDED,
}

# a JAX parameter under another name in the port
RENAMED_ANYWHERE = {"dtype": "compute_dtype"}
RENAMED = {
    "models.prestack.BasicBlock": {"features": "out", "strides": "stride"},
    "parallel.distributed.initialize": {
        "coordinator_address": "address", "num_processes": "world",
        "process_id": "rank_", "local_device_ids": "local_rank"},
    "parallel.mesh.replicate": {"tree": "obj"},
    "utils.param_count": {"params": "model"},
    "utils.summary": {"variables": "model"},
}

OF_INPUT = ("unused by the JAX dataclass: the frontend's bins set the "
            "trunk's width (`make_frontend`)")
MESH = ("a jax Mesh and its axis names; the port's `MeshContext` holds "
        "rank, world, device, sp and the sp group")
WEIGHTS = "the weights; the port's model holds them"
JAX_ONLY_PARAMS = {
    "models.onsets_frames.OnsetsAndFrames": {"input_features": OF_INPUT,
                                             "n_heads": N_HEADS},
    "models.onsets_frames.FrameStackVAT": {"input_features": OF_INPUT,
                                           "n_heads": N_HEADS},
    "models.onsets_frames.OnsetStackVAT": {"input_features": OF_INPUT,
                                           "n_heads": N_HEADS},
    "models.reconvat.ReconVAT": {"n_heads": N_HEADS},
    "models.unet_onset.UNetOnset": {"n_heads": N_HEADS},
    "models.prestack.Prestack": {"n_heads": N_HEADS},
    "models.thickstun.Thickstun": {"n_heads": N_HEADS},
    "models.prestack.ResNet18": {
        "in_features": "unused by the JAX module: its first convolution "
                       "infers the input width"},
    "nn.attention.banded_attention": {
        "return_probs": "False skips writing the probabilities (a speed "
                        "option); the port returns them always",
        "seq_major": "the TPU operands' layout; the port's is (B, L, "
                     "heads, Dh)"},
    "nn.attention.MultiHeadAttention1D": {
        "impl": "picks the Pallas or XLA route on a TPU; the port's is "
                "`use_kernel`",
        "pallas_block": "the Pallas kernel's block; the port's kernels "
                        "tile themselves"},
    "evaluate.make_bucketed_runner": {"variables": WEIGHTS},
    "models.common.transcribe_streaming": {"variables": WEIGHTS},
    "data.loader.prefetch_to_device": {
        "put": "a jax device_put; the port takes the target `device`"},
    "parallel.mesh.MeshContext": {"mesh": MESH, "batch_axis": MESH,
                                  "time_axis": MESH, "dcn_axis": MESH},
    "parallel.mesh.activate": {"mesh": MESH, "batch_axis": MESH,
                               "time_axis": MESH},
    "parallel.mesh.make_mesh": {
        "n_devices": "the port's world is its process group's, one rank "
                     "a process"},
    "train.state.TrainState": {
        leaf: "flax and optax state; the port's TrainState holds the "
              "optimizer and its schedule, the model its weights"
        for leaf in ("params", "batch_stats", "opt_state", "tx")},
    "train.state.make_optimizer": {
        "clip_gradient_norm": "the port clips in `apply_gradients` by "
                              "TrainState.clip_gradient_norm "
                              "(`create_train_state` takes it)"},
    "train.state.create_train_state": {
        "seq_frames": "the frames of flax's init trace; a torch model is "
                      "built with its weights"},
    "train.state.make_train_step": {"donate": "jax buffer donation"},
}

EXEMPT = dict(modules=JAX_ONLY_MODULES, names=JAX_ONLY_NAMES,
              anywhere=JAX_ONLY_ANYWHERE, params=JAX_ONLY_PARAMS,
              renamed_anywhere=RENAMED_ANYWHERE, renamed=RENAMED)


def _public(module):
    """The public classes and functions defined in `module`."""
    for attr, obj in sorted(vars(module).items()):
        if (not attr.startswith("_")
                and (inspect.isclass(obj) or inspect.isfunction(obj))
                and obj.__module__ == module.__name__):
            yield attr, obj


def _params(obj):
    """The named parameters of a class's constructor or a function."""
    return [p.name for p in inspect.signature(obj).parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def api_gaps(jax_pkg, port_name: str, exempt: dict) -> list[str]:
    """Every place where the package `port_name` lacks a module, a name or
    a parameter of the package `jax_pkg` that `exempt` does not excuse,
    and every exception of `exempt` (but the `anywhere` ones) that
    excuses nothing."""
    gaps, used = [], set()
    for info in pkgutil.walk_packages(jax_pkg.__path__,
                                      jax_pkg.__name__ + "."):
        rel = info.name[len(jax_pkg.__name__) + 1:]
        jax_mod = importlib.import_module(info.name)
        try:
            port_mod = importlib.import_module(f"{port_name}.{rel}")
        except ModuleNotFoundError:
            if rel in exempt["modules"]:
                used.add(("modules", rel))
            else:
                gaps.append(f"module {rel}")
            continue
        for attr, obj in _public(jax_mod):
            key = f"{rel}.{attr}"
            if not hasattr(port_mod, attr):
                if key in exempt["names"]:
                    used.add(("names", key))
                else:
                    gaps.append(f"name {key}")
                continue
            port_params = set(_params(getattr(port_mod, attr)))
            renamed = {**exempt["renamed_anywhere"],
                       **exempt["renamed"].get(key, {})}
            for p in _params(obj):
                if p in port_params:
                    continue
                if renamed.get(p) in port_params:
                    used.add(("renamed", key, p))
                elif p in exempt["params"].get(key, {}):
                    used.add(("params", key, p))
                elif p not in exempt["anywhere"]:
                    gaps.append(f"parameter {key}({p})")
    stale = ([("modules", m) for m in exempt["modules"]]
             + [("names", n) for n in exempt["names"]]
             + [("params", k, p) for k, ps in exempt["params"].items()
                for p in ps]
             + [("renamed", k, p) for k, ps in exempt["renamed"].items()
                for p in ps])
    gaps += [f"stale exception {e}" for e in stale if e not in used]
    return gaps


def test_port_has_every_module_name_and_parameter():
    assert api_gaps(reconvat_tpu, "reconvat_tpu_torch", EXEMPT) == []


def test_every_exception_has_a_reason():
    for table in (JAX_ONLY_MODULES, JAX_ONLY_NAMES, JAX_ONLY_ANYWHERE,
                  *JAX_ONLY_PARAMS.values()):
        for key, reason in table.items():
            assert isinstance(reason, str) and reason.strip(), key


def _write(root, files: dict) -> None:
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))


def test_walker_reports_a_planted_gap(tmp_path, monkeypatch):
    """A fake pair of packages: the port's `Frontend` lacks the argument
    `power`, the port lacks `helper` and the module `extra`, and one
    exception excuses nothing; each is reported, and nothing else (the
    renamed `dtype`, the excused `precision` and the private names)."""
    _write(tmp_path, {
        "fakejax/__init__.py": "",
        "fakejax/ops.py": """
            class Frontend:
                def __init__(self, n_fft=2048, power=2.0, dtype=None,
                             precision=None):
                    pass

            def helper(x):
                return x

            def _private(y):
                return y
            """,
        "fakejax/extra.py": "def anything():\n    pass\n",
        "fakejax_torch/__init__.py": "",
        "fakejax_torch/ops.py": """
            class Frontend:
                def __init__(self, n_fft=2048, compute_dtype=None):
                    pass
            """,
    })
    monkeypatch.syspath_prepend(str(tmp_path))
    import fakejax

    exempt = dict(modules={}, names={"ops.gone": "removed"},
                  anywhere={"precision": "TPU"}, params={},
                  renamed_anywhere={"dtype": "compute_dtype"}, renamed={})
    gaps = api_gaps(fakejax, "fakejax_torch", exempt)
    assert sorted(gaps) == sorted([
        "module extra", "name ops.helper", "parameter ops.Frontend(power)",
        "stale exception ('names', 'ops.gone')"]), gaps
    exempt["modules"] = {"extra": "JAX only"}
    exempt["names"] = {"ops.helper": "JAX only"}
    exempt["params"] = {"ops.Frontend": {"power": "JAX only"}}
    assert api_gaps(fakejax, "fakejax_torch", exempt) == []
