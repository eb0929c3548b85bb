#!/usr/bin/env python
"""Experiment launcher of the port: a hyper-parameter search over
``python -m climategan_torch.train`` runs, the twin of the root
``launch.py`` (a re-design of the reference's sbatch.py).

    python -m climategan_torch.launch -e experiment.yaml --dry
    python -m climategan_torch.launch -e experiment.yaml \\
        --scripts_dir runs/ --submit sbatch|bash|background
    python -m climategan_torch.launch -e experiment.yaml \\
        --nproc_per_node 4 --submit bash

An experiment YAML (``config/experiment_showcase.yaml``) expands into one
set of dotted ``key=value`` overrides per run, drawn as the root launcher
draws them (``sample_value``, ``expand``: the same draws from
``random.Random(seed)``):

  runs: 4                      # number of sampled runs (ignored: cartesian)
  searches:
    gen.opt.lr.default: {sample: list, from: [1e-4, 5e-5]}
    dis.opt.lr.default: {sample: range, from: [1e-5, 1e-4]}   # log-uniform
    train.epochs:       {sample: uniform, from: [10, 50]}
    gen.opt.optimizer:  {sample: sequential, from: [ExtraAdam, Adam]}
  cartesian: false             # true => cross-product of all `from` lists
  base_overrides:
    output_path: /runs/search_{i}   # {i}: the run's index
  nproc_per_node: 4            # optional: ranks per host (or the flag)
  script: my_train.py          # optional: a file to run instead

Each run's command is ``python -m climategan_torch.train k=v ...``. With
``--nproc_per_node N`` (or the YAML's ``nproc_per_node``) it is ``python -m
torch.distributed.run --standalone --nproc_per_node N -m
climategan_torch.train k=v ...``: one rank per card of the host (the JAX
package used every local chip from one process). ``--device cpu`` is
passed on to the trainer. The commands are printed (``--dry``), run one
after the other, or written as one ``/bin/sh`` script per run
(``--scripts_dir``, with ``#SBATCH`` headers from the YAML's ``slurm:``
section) and submitted (``--submit``).
"""
from __future__ import annotations

import argparse
import itertools
import math
import random
import shlex
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

import yaml

TRAIN_MODULE = "climategan_torch.train"


def sample_value(spec, rng: random.Random):
    """One draw of a search: ``list`` (a choice), ``uniform``, ``range``
    (log-uniform between the bounds) or ``sequential`` (the list itself,
    which ``expand`` walks)."""
    mode = spec.get("sample", "list")
    src = spec.get("from")
    if mode == "list":
        return rng.choice(src)
    if mode == "uniform":
        lo, hi = float(src[0]), float(src[1])
        return rng.uniform(lo, hi)
    if mode == "range":
        lo, hi = float(src[0]), float(src[1])
        return math.exp(rng.uniform(math.log(lo), math.log(hi)))
    if mode == "sequential":
        return src
    raise ValueError(f"Unknown sampling mode {mode}")


def expand(exp: dict, seed: int = 0) -> List[Dict]:
    """The runs' overrides: the cross-product of the searches' lists
    (``cartesian``), else ``max(runs, longest sequential list)`` draws,
    each over ``base_overrides``; ``{i}`` in a string value becomes the
    run's index."""
    rng = random.Random(seed)
    searches = exp.get("searches", {}) or {}
    base = exp.get("base_overrides", {}) or {}
    runs = int(exp.get("runs", 1))

    configs = []
    if exp.get("cartesian"):
        keys = list(searches.keys())
        value_lists = [s["from"] for s in searches.values()]
        for combo in itertools.product(*value_lists):
            configs.append({**base, **dict(zip(keys, combo))})
    else:
        seq_keys = {k: s["from"] for k, s in searches.items()
                    if s.get("sample") == "sequential"}
        n = max([runs] + [len(v) for v in seq_keys.values()])
        for i in range(n):
            cfg = dict(base)
            for k, s in searches.items():
                if s.get("sample") == "sequential":
                    cfg[k] = s["from"][i % len(s["from"])]
                else:
                    cfg[k] = sample_value(s, rng)
            configs.append(cfg)
    return [{k: (v.format(i=i) if isinstance(v, str) and "{i}" in v else v)
             for k, v in cfg.items()}
            for i, cfg in enumerate(configs)]


def to_cmd(cfg: dict, script: Optional[str] = None,
           nproc_per_node: Optional[int] = None,
           device: Optional[str] = None) -> List[str]:
    """The command of one run: ``python -m climategan_torch.train`` (or
    ``python <script>``), under ``torch.distributed.run`` with
    ``nproc_per_node`` ranks, ``--device`` when given, then the
    overrides."""
    parts = [sys.executable]
    if nproc_per_node:
        parts += ["-m", "torch.distributed.run", "--standalone",
                  "--nproc_per_node", str(int(nproc_per_node))]
    parts += [script] if script else ["-m", TRAIN_MODULE]
    if device:
        parts += ["--device", device]
    parts += [f"{k}={v}" for k, v in cfg.items()]
    return parts


# header keys understood in the experiment YAML's `slurm:` section, in the
# reference's template order (sbatch.py / shared/template/*.sh)
_SLURM_KEYS = (
    ("job_name", "--job-name"),
    ("partition", "--partition"),
    ("time", "--time"),
    ("mem", "--mem"),
    ("cpus", "--cpus-per-task"),
    ("gres", "--gres"),
    ("output", "--output"),
    # multi-node training: ntasks > 1 starts one process per task, and the
    # port's trainer joins torch.distributed from the SLURM environment
    # (SLURM_PROCID, SLURM_NTASKS, MASTER_ADDR, MASTER_PORT;
    # climategan_torch/parallel/distributed.py)
    ("nodes", "--nodes"),
    ("ntasks", "--ntasks"),
)


def render_script(line: str, i: int, slurm: Optional[dict]) -> str:
    """One runnable script per run; with a `slurm:` section it gets #SBATCH
    headers like the reference's generated scripts (sbatch.py templates)."""
    header = ["#!/bin/sh"]
    if slurm:
        for key, flag in _SLURM_KEYS:
            if key in slurm:
                val = str(slurm[key]).format(i=i)
                header.append(f"#SBATCH {flag}={val}")
    return "\n".join(header) + f"\n{line}\n"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m climategan_torch.launch")
    ap.add_argument("-e", "--experiment", required=True,
                    help="experiment YAML file")
    ap.add_argument("--dry", action="store_true", help="print commands only")
    ap.add_argument("--scripts_dir", default=None,
                    help="write one .sh per run instead of executing")
    ap.add_argument("--submit", choices=["none", "sbatch", "bash",
                                         "background"],
                    default="none",
                    help="submit the generated scripts: sbatch (SLURM, like "
                         "the reference), bash (sequential), background "
                         "(parallel local processes; pids written next to "
                         "the scripts)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nproc_per_node", type=int, default=None,
                    help="ranks per host: each run under python -m "
                         "torch.distributed.run --standalone (default: the "
                         "YAML's nproc_per_node, else one process)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="passed on to the trainer (default: its own, the "
                         "card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    with open(args.experiment) as f:
        exp = yaml.safe_load(f)

    configs = expand(exp, args.seed)
    slurm = exp.get("slurm") or None
    nproc = args.nproc_per_node or exp.get("nproc_per_node")
    print(f"{len(configs)} runs")

    scripts = []
    for i, cfg in enumerate(configs):
        cmd = to_cmd(cfg, exp.get("script"), nproc, args.device)
        line = " ".join(shlex.quote(c) for c in cmd)
        if args.dry:
            print(line)
            continue
        if args.scripts_dir or args.submit != "none":
            d = Path(args.scripts_dir or "launch_scripts")
            d.mkdir(parents=True, exist_ok=True)
            sh = d / f"run_{i:03d}.sh"
            sh.write_text(render_script(line, i, slurm))
            sh.chmod(0o755)
            scripts.append(sh)
            print(f"wrote {sh}")
        else:
            print(f"--- run {i} ---\n{line}", flush=True)
            subprocess.run(cmd, check=True)

    if args.submit == "sbatch":
        if shutil.which("sbatch") is None:
            print("sbatch not found on this host; scripts were written but "
                  "not submitted", file=sys.stderr)
            return 1
        for sh in scripts:
            out = subprocess.run(["sbatch", str(sh)], capture_output=True,
                                 text=True, check=True)
            print(out.stdout.strip())
    elif args.submit == "bash":
        for sh in scripts:
            print(f"--- {sh.name} ---", flush=True)
            subprocess.run(["/bin/sh", str(sh)], check=True)
    elif args.submit == "background":
        for sh in scripts:
            log = sh.with_suffix(".log")
            with open(log, "w") as lf:
                proc = subprocess.Popen(["/bin/sh", str(sh)], stdout=lf,
                                        stderr=subprocess.STDOUT)
            sh.with_suffix(".pid").write_text(str(proc.pid))
            print(f"started {sh.name} pid={proc.pid} log={log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
