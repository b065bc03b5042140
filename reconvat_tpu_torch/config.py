"""Minimal sacred-compatible experiment framework (the port's copy of
`reconvat_tpu/config.py`).

The reference drives every entry point through `sacred`
(`train_UNet_Onset_VAT.py:15-87`): an `@ex.config` function whose local
variables are the config, `with key=value` CLI overrides and
`print_config`. The config function body is re-executed with overridden
assignments pinned to the override value, so derived values see the
overridden inputs. A `FileStorageObserver` that a config body appends to
`ex.observers` archives the run's resolved config, its command line and the
entry point's source in the run directory.
"""
from __future__ import annotations

import ast
import contextlib
import inspect
import json
import os
import sys
import textwrap
from datetime import datetime


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_cli(argv=None):
    """Returns (commands, overrides) from sacred-style argv:
    `script.py [print_config] [with k=v ...]`."""
    argv = list(sys.argv[1:] if argv is None else argv)
    commands, overrides = [], {}
    in_with = False
    for arg in argv:
        if arg == "with":
            in_with = True
            continue
        if in_with and "=" in arg:
            key, _, val = arg.partition("=")
            overrides[key] = _parse_value(val)
        else:
            commands.append(arg)
    return commands, overrides


class _OverrideTransformer(ast.NodeTransformer):
    """Pin assignments of overridden names to the override value."""

    def __init__(self, overrides):
        self.overrides = overrides

    def _pin(self, name):
        return ast.parse(f"{name} = __overrides__[{name!r}]").body[0]

    def visit_Assign(self, node):
        if (len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in self.overrides):
            return ast.copy_location(self._pin(node.targets[0].id), node)
        return node

    def visit_AugAssign(self, node):
        if isinstance(node.target, ast.Name) \
                and node.target.id in self.overrides:
            return ast.copy_location(self._pin(node.target.id), node)
        return node


def resolve_config(config_fn, overrides):
    """Execute a config function's body with overrides pinned, returning its
    final local namespace (the config dict)."""
    source = textwrap.dedent(inspect.getsource(config_fn))
    tree = ast.parse(source)
    fn: ast.FunctionDef = tree.body[0]  # type: ignore[assignment]
    body = ast.Module(body=fn.body, type_ignores=[])
    body = _OverrideTransformer(overrides or {}).visit(body)
    ast.fix_missing_locations(body)

    glb = dict(config_fn.__globals__)
    glb["__overrides__"] = dict(overrides or {})
    loc: dict = {}
    exec(compile(body, f"<config:{config_fn.__name__}>", "exec"), glb, loc)
    cfg = {k: v for k, v in loc.items() if not k.startswith("_")}
    # overrides that never appear in the config body still apply
    for k, v in (overrides or {}).items():
        cfg.setdefault(k, v)
    return cfg


class FileStorageObserver:
    """Writes `config.json` (the resolved config's plain values),
    `run.json` (experiment name, start time, argv) and `_sources/` (the
    entry point's source file) into `basedir`."""

    def __init__(self, basedir):
        self.basedir = basedir

    @classmethod
    def create(cls, basedir):
        return cls(basedir)

    def start(self, experiment_name, config, source_path=None):
        os.makedirs(self.basedir, exist_ok=True)
        cfg = {k: v for k, v in config.items()
               if isinstance(v, (int, float, str, bool, list, dict,
                                 tuple, type(None)))}
        with open(os.path.join(self.basedir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)
        with open(os.path.join(self.basedir, "run.json"), "w") as f:
            json.dump({"experiment": experiment_name,
                       "start_time": datetime.now().isoformat(),
                       "argv": sys.argv}, f, indent=2)
        if source_path and os.path.exists(source_path):
            os.makedirs(os.path.join(self.basedir, "_sources"),
                        exist_ok=True)
            with open(source_path) as src, open(
                    os.path.join(self.basedir, "_sources",
                                 os.path.basename(source_path)), "w") as dst:
                dst.write(src.read())


class _Run:
    def __init__(self, config):
        self.config = config


class Experiment:
    def __init__(self, name, check=None, launch=None):
        """`check(config)`, when given, runs on each resolved config before
        the observers start, so a run it refuses writes nothing.
        `launch(config, main_fn, overrides)`, when given, is a context
        manager around the run that yields whether this process is the one
        that writes (the training CLIs' `driver.start_ranks`: rank 0 of a
        data-parallel run); the observers start only there."""
        self.name = name
        self.check = check
        self.launch = launch
        self._config_fns = []
        self.observers = []
        self.current_run = None

    def config(self, fn):
        self._config_fns.append(fn)
        return fn

    def _resolve(self, overrides):
        cfg = {}
        for fn in self._config_fns:
            cfg.update(resolve_config(fn, {**cfg, **(overrides or {})}))
        return cfg

    def run(self, main_fn, overrides=None, commands=()):
        """Resolve the config with `overrides` and call `main_fn` with the
        config values its parameters name; returns what it returns (None
        for `print_config`). The observers the config body appends start
        before `main_fn` runs; each run starts with none."""
        self.observers = []
        cfg = self._resolve(overrides or {})
        self.current_run = _Run(cfg)
        if "print_config" in commands:
            print_config(self.current_run)
            return None
        if self.check is not None:
            self.check(cfg)
        launch = (self.launch(cfg, main_fn, overrides or {})
                  if self.launch is not None else contextlib.nullcontext(True))
        with launch as writes:
            return self._call(main_fn, cfg, writes)

    def _call(self, main_fn, cfg, writes):
        if writes:
            for obs in self.observers:
                obs.start(self.name, cfg,
                          source_path=inspect.getsourcefile(main_fn))
        sig = inspect.signature(main_fn)
        has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in sig.parameters.values())
        kwargs = {}
        for pname, p in sig.parameters.items():
            if p.kind is inspect.Parameter.VAR_KEYWORD:
                continue
            if pname in cfg:
                kwargs[pname] = cfg[pname]
            elif p.default is inspect.Parameter.empty:
                raise TypeError(f"config has no value for parameter "
                                f"'{pname}' of {main_fn.__name__}")
        if has_var_kw:
            for k, v in cfg.items():
                kwargs.setdefault(k, v)
        return main_fn(**kwargs)

    def automain(self, fn):
        """Decorate the entry point; when its module runs as `__main__`,
        parse the command line and run it."""
        if fn.__module__ == "__main__":
            commands, overrides = parse_cli()
            self.run(fn, overrides, commands)
        return fn


def print_config(run: _Run):
    print("Configuration (modified, added, typechanged, doc):")
    for k in sorted(run.config):
        print(f"  {k} = {run.config[k]!r}")
