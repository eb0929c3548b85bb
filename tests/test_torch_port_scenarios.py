"""The port's twin of the JAX package's scenario table
(tests/test_scenarios.py): every entry of its ``SCENARIOS``, plus its
DeepLab v2 and painter-with-z scenarios, through the port's training step
at 32^2 on the CPU, with no JAX step.

Each entry either takes one ``train_step`` (g_step, then d_step) with
finite losses and moved parameters in every model it updates, as
``test_scenario_trains`` asserts of the JAX step, or raises a
``ValueError`` naming its ROADMAP item: only the entries of ROADMAP A.8's
remainder (diff-aug, pl4m) may.
"""
import pytest
import torch

from climategan_torch.train_step import StepBuilder
from climategan_torch.utils.opts import load_opts
from tests.test_scenarios import SCENARIOS, _opts_for, _scenario_batch
from tests.torch_port_common import one_thread, port_batch  # noqa: F401

# tests/test_scenarios.py's test_deeplabv2_scenario and
# test_painter_with_sampled_z, as table entries
EXTRA = [
    {"__doc": "deeplabv2 encoder and seg decoder",
     "gen": {"encoder": {"architecture": "deeplabv2"},
             "s": {"architecture": "deeplabv2"}}},
    {"__doc": "painter with sampled z", "gen": {"p": {"no_z": False}}},
]
REFUSED = {"painter diff-aug": "ROADMAP A.8 remainder",
           "pl4m end-to-end": "ROADMAP A.8 remainder"}
ALL = SCENARIOS + EXTRA


@pytest.mark.parametrize("scenario", ALL, ids=[s["__doc"] for s in ALL])
def test_scenario_trains_or_names_its_roadmap_item(scenario):
    jopts = _opts_for(scenario)
    opts = load_opts(default=jopts.to_dict())
    doc = scenario["__doc"]
    if doc in REFUSED:
        with pytest.raises(ValueError, match=REFUSED[doc]):
            StepBuilder(opts)
        return
    builder = StepBuilder(opts)
    state = builder.init_state(0, "cpu")
    G, D = state.G, state.D
    before = {f"{net}.{n}": p.detach().clone()
              for net, m in (("G", G), ("D", D))
              for n, p in m.named_parameters()}
    state, metrics = builder.train_step(state, port_batch(
        _scenario_batch(jopts)))
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), f"{k} not finite: {v}"
    moved = {f"{net}.{n}" for net, m in (("G", G), ("D", D))
             for n, p in m.named_parameters()
             if not torch.equal(p, before[f"{net}.{n}"])}
    # every part of G the config builds moves (the encoder, the task heads,
    # the painter); of D, every part when a D loss is active
    parts = [f"G.{name}." for name in ("encoder", "painter") if hasattr(G, name)]
    parts += [f"G.decoders.{t}." for t in G.decoders]
    if float(metrics["d_total"]) != 0.0:
        parts += [f"D.{name}." for name, _ in D.named_children()]
    for part in parts:
        assert any(n.startswith(part) for n in moved), f"{doc}: {part} did not move"
