"""Config / opts loader: defaults.yaml <- config file <- dotted overrides.

The same semantics as the JAX package's loader (attribute-access dict, deep
merge, hydra-style ``a.b=c`` overrides, ``opts.domains`` derived from
``opts.tasks``, ``opts.events`` from events.yaml), reading this package's own
copy of the two YAML files under ``climategan_torch/config/``.
"""
from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Mapping, Optional

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

    def to_dict(self) -> dict:
        """Plain dicts and lists all the way down (for YAML and JSON)."""
        def plain(v):
            if isinstance(v, Mapping):
                return {k: plain(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [plain(x) for x in v]
            return v
        return plain(self)


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


def env_expand(path) -> str:
    """Expand $ENV vars and ~ in a path (reference utils.py:367)."""
    return os.path.expanduser(os.path.expandvars(str(path)))


def flatten_opts(opts: Mapping, prefix: str = "") -> dict:
    """Nested opts -> {dotted.key: leaf} (reference utils.py:385)."""
    out = {}
    for k, v in opts.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_opts(v, key))
        elif isinstance(v, list) and v and isinstance(v[0], Mapping):
            for i, item in enumerate(v):
                out.update(flatten_opts(item, f"{key}.{i}"))
        else:
            out[key] = v
    return out


def _job_id(job_id: Optional[str] = None) -> Optional[str]:
    return job_id or os.environ.get("CLIMATEGAN_JOB_ID") \
        or os.environ.get("SLURM_JOBID")


def find_existing_training(opts, job_id: Optional[str] = None):
    """Auto-resume (reference utils.py:741-805, train.py:87-100): the
    newest sibling of ``opts.output_path`` whose ``job_id.txt`` holds this
    job's id (CLIMATEGAN_JOB_ID or SLURM_JOBID), else None."""
    job_id = _job_id(job_id)
    if not job_id:
        return None
    base = Path(env_expand(opts.output_path)).resolve()
    candidates = [d for d in base.parent.glob(base.name + "*")
                  if (d / "job_id.txt").exists()
                  and (d / "job_id.txt").read_text().strip() == str(job_id)]
    if not candidates:
        return None
    return max(candidates, key=lambda d: d.stat().st_mtime)


def write_job_id(output_path, job_id: Optional[str] = None) -> None:
    job_id = _job_id(job_id)
    if job_id:
        Path(output_path).mkdir(parents=True, exist_ok=True)
        (Path(output_path) / "job_id.txt").write_text(str(job_id))


def get_increased_path(path) -> Path:
    """A path that does not exist yet: ``path`` itself, else its sibling
    with " (i)" appended (reference utils.py:308-340)."""
    path = Path(path).resolve()
    if not path.exists():
        return path
    stem = re.sub(r" \(\d+\)$", "", path.name)
    i = 1
    while (path.parent / f"{stem} ({i})").exists():
        i += 1
    return path.parent / f"{stem} ({i})"
