#!/usr/bin/env python
"""Training CLI of the port, on the card unless ``--device cpu``:

    python -m climategan_torch.train args.config=my_config.yaml \\
        data.loaders.batch_size=2 train.epochs=10
    python -m climategan_torch.train args.resume=true output_path=<run dir>

The root ``train.py``'s surface: dotted ``key=value`` overrides over
defaults.yaml (and ``args.config=``'s file), ``args.resume=true`` (or
``train.resume``) to continue the run in ``output_path``; otherwise a run
dir that exists already gets a fresh sibling (``get_increased_path``).
``train.auto_resume`` finds the run of this job (CLIMATEGAN_JOB_ID or
SLURM_JOBID). The run dir receives ``opts.yaml``, ``train.jsonl``,
``images/``, ``archi_num_params.txt`` and ``checkpoints/``
(``latest_ckpt.pth`` every epoch, ``epoch_N.pth`` at the keep epochs,
``latest.json``) with ``opts.json``; ``apply_events -r <run dir>`` serves
it. ``comet.use`` logs to comet.ml when ``comet_ml`` is installed.

Data parallel, one rank per card (or ``--device cpu`` ranks on gloo):

    python -m torch.distributed.run --nproc_per_node 4 \
        -m climategan_torch.train data.loaders.batch_size=8 ...

Each rank runs on ``cuda:LOCAL_RANK`` over NCCL (``--dist_backend gloo``
takes gloo instead); rank 0 picks the run dir and writes everything in
it; the world size must divide the per-domain batch
(``trainer.check_data_axis``).

Row-sharded, each image's rows split over k cards of each rank (hybrid
data x space over several ranks; k shards of the CPU with ``--device
cpu``):

    python -m torch.distributed.run --nproc_per_node <cards / k> \
        -m climategan_torch.train tpu.spatial_shards=k ...

Rank r runs on the cards [r k, (r + 1) k); where k does not divide the
rank's cards it prints the JAX trainer's message and trains unsharded.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def setup_comet(opts, resuming: bool):
    """A comet experiment (reference train.py:108-172): on resume, the one
    recorded in the run dir, else a new one with the package's sources,
    tags and the flattened opts. comet is optional: without it, or when it
    fails, the run logs to the console and JSONL only."""
    if not opts.get("comet", {}).get("use"):
        return None
    out = Path(str(opts.output_path))
    try:
        import comet_ml

        from climategan_torch.utils.opts import flatten_opts

        exp = None
        id_file = out / "comet_id.txt"
        if resuming and id_file.exists():
            prev = id_file.read_text().strip()
            if prev:
                print(f"continuing comet experiment {prev}")
                exp = comet_ml.ExistingExperiment(previous_experiment=prev)
        if exp is None:
            exp = comet_ml.Experiment(project_name="climategan_torch")
            exp.log_asset_folder(str(Path(__file__).parent), recursive=True,
                                 log_file_name=True)
        tags = list(opts.get("comet", {}).get("tags") or [])
        if tags:
            exp.add_tags(tags)
        exp.log_parameters(flatten_opts(opts))
        id_file.write_text(exp.id)
        (out / "comet_url.txt").write_text(str(exp.url))
        return exp
    except Exception as e:  # an optional remote logger
        print(f"comet disabled ({e}); logging to console/JSONL only")
        return None


def main(argv=None) -> int:
    from climategan_torch.parallel import distributed

    parser = argparse.ArgumentParser(prog="python -m climategan_torch.train")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain versions of "
                             "the kernels)")
    parser.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="the process group's backend under "
                             "torch.distributed.run (default: nccl on a "
                             "card, gloo on the CPU)")
    args, rest = parser.parse_known_args(argv)
    bad = [a for a in rest if "=" not in a]
    if bad:
        parser.error(f"overrides are key=value, got {bad}")
    from climategan_torch.parallel.mesh import spatial_shards
    from climategan_torch.utils.opts import load_opts, parse_overrides

    overrides = parse_overrides(rest)
    cli = overrides.pop("args", None) or {}
    opts = load_opts(path=cli.get("config"), commandline_opts=overrides)
    # join the process group before anything touches the card
    device = distributed.maybe_init_distributed(
        args.device, args.dist_backend, verbose=1,
        spatial_shards=spatial_shards(opts))
    try:
        return _train(opts, cli, device)
    finally:
        distributed.shutdown()


def _train(opts, cli, device) -> int:
    import yaml

    from climategan_torch.parallel import distributed
    from climategan_torch.trainer import Trainer
    from climategan_torch.utils.opts import (
        find_existing_training,
        get_increased_path,
        write_job_id,
    )

    resume = bool(cli.get("resume"))

    out = Path(str(opts.output_path))
    resume = resume or bool(opts.train.get("resume"))
    if opts.train.get("auto_resume") and not resume:
        existing = find_existing_training(opts)
        if existing is not None:
            print(f"auto-resume: found matching run {existing}")
            out, resume = existing, True
    main = distributed.is_main()
    if main:
        if not resume:
            out = get_increased_path(out)
        out.mkdir(parents=True, exist_ok=True)
        write_job_id(out)
        print(f"output_path: {out}")
    # rank 0's run dir and resume on every rank
    out, resume = distributed.broadcast_object((str(out), resume))
    out = Path(out)
    opts.output_path = str(out)

    comet_exp = setup_comet(opts, resuming=resume) if main else None
    if main:
        with (out / "opts.yaml").open("w") as f:
            yaml.safe_dump(opts.to_dict(), f)

    trainer = Trainer(opts, comet_exp=comet_exp, device=device)
    trainer.setup()
    if resume:
        trainer.resume()
    trainer.train()
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
