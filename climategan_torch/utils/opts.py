"""Config / opts loader: defaults.yaml <- config file <- dotted overrides.

The same semantics as the JAX package's loader (attribute-access dict, deep
merge, hydra-style ``a.b=c`` overrides, ``opts.domains`` derived from
``opts.tasks``, ``opts.events`` from events.yaml), reading this package's own
copy of the two YAML files under ``climategan_torch/config/``.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Mapping

import yaml

_CONFIG_DIR = Path(__file__).resolve().parent.parent / "config"
DEFAULTS_PATH = _CONFIG_DIR / "defaults.yaml"
EVENTS_PATH = _CONFIG_DIR / "events.yaml"


class Opts(dict):
    """A dict with attribute access; missing keys read as an empty Opts
    (addict semantics, which optional lookups like ``opts.events.fire``
    rely on)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            if not isinstance(arg, Mapping):
                raise TypeError(f"Cannot build Opts from {type(arg)}")
            for k, v in arg.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, Opts):
            value = Opts(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                Opts(v) if isinstance(v, Mapping) and not isinstance(v, Opts) else v
                for v in value
            )
        super().__setitem__(key, value)

    def __getattr__(self, key):
        if key.startswith("__") and key.endswith("__"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError:
            return Opts()

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e


def merge(source: Mapping, destination: Opts) -> Opts:
    """Deep-merge ``source`` into ``destination`` (source wins)."""
    for key, value in source.items():
        if isinstance(value, Mapping):
            node = destination.get(key)
            if not isinstance(node, Mapping):
                node = Opts()
                destination[key] = node
            merge(value, node)
        else:
            destination[key] = value
    return destination


def _parse_value(value: str) -> Any:
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def set_dotted(opts: Opts, dotted_key: str, value: Any) -> None:
    """Set ``opts`` at a dotted key path, creating intermediate Opts."""
    parts = dotted_key.split(".")
    node = opts
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, Opts):
            nxt = Opts()
            node[p] = nxt
        node = nxt
    node[parts[-1]] = value


def parse_overrides(args: list[str]) -> Opts:
    """Parse ``key.sub=value`` overrides (values read as YAML)."""
    out = Opts()
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"Override must be key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        set_dotted(out, key.strip(), _parse_value(value))
    return out


def load_yaml(path) -> Opts:
    with open(path, "r") as f:
        return Opts(yaml.safe_load(f) or {})


def load_opts(path=None, default=None, commandline_opts=None) -> Opts:
    """Load the full opts tree.

    Precedence: ``default`` (path or dict, defaults.yaml when None) <-
    ``path`` (config file or dict) <- ``commandline_opts`` (dict or list of
    "a.b=c" strings). Derives ``opts.domains`` from the tasks and attaches
    events.yaml as ``opts.events``.
    """
    if default is None:
        default = DEFAULTS_PATH
    if isinstance(default, (str, Path)):
        opts = load_yaml(default)
    else:
        opts = Opts(copy.deepcopy(dict(default)))

    if path is not None:
        overrides = load_yaml(path) if isinstance(path, (str, Path)) else Opts(path)
        opts = merge(overrides, opts)

    if commandline_opts is not None:
        if isinstance(commandline_opts, (list, tuple)):
            commandline_opts = parse_overrides(list(commandline_opts))
        opts = merge(Opts(commandline_opts), opts)

    tasks = list(opts.get("tasks") or [])
    domains = []
    if any(t in tasks for t in "msd"):
        domains.extend(["r", "s"])
    if "p" in tasks:
        domains.append("rf")
    if opts.get("data", Opts()).get("files", Opts()).get("train", Opts()).get("kitti"):
        if opts.train.get("kitti", Opts()).get("pretrain"):
            domains.append("kitti")
    opts["domains"] = domains

    if "events" not in opts:
        opts["events"] = load_yaml(EVENTS_PATH)
    return opts
