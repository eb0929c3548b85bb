"""The port's kernels on the CPU: plain versions vs the JAX Pallas kernels
(interpret mode), and the wrappers' CPU dispatch. The kernels themselves are
held to their plain versions on the card by tests/test_torch_port_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from climategan_tpu.ops.pallas.events import masked_blend as jax_masked_blend
from climategan_tpu.ops.pallas.spade import spade_cond as jax_spade_cond
from climategan_torch.kernels import launches, reset_launches
from climategan_torch.kernels.masked_blend import masked_blend, masked_blend_plain
from climategan_torch.kernels.spade_cond import (
    _check,
    block_chunks,
    chunk_width,
    pack_spade_cond,
    plan_groups,
    spade_cond,
    spade_cond_packed_plain,
    spade_cond_plain,
)
from climategan_torch.models.generator import GenConfig


def _spade_case(seed, N, H, W, cnc, hids, ncs, b1_value=None):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    seg = r(N, H, W, cnc)
    k1 = r(3, 3, cnc, sum(hids))
    b1 = (np.full((sum(hids),), b1_value, np.float32) if b1_value is not None
          else r(sum(hids)))
    branches = [(r(3, 3, h, nc), r(nc), r(3, 3, h, nc), r(nc))
                for h, nc in zip(hids, ncs)]
    return seg, k1, b1, branches


# the JAX kernel test's own cases (tests/test_pallas_spade.py)
SPADE_CASES = {
    "single": dict(seed=0, N=2, H=32, W=48, cnc=3, hids=(16,), ncs=(8,)),
    "dual": dict(seed=1, N=1, H=16, W=32, cnc=3, hids=(16, 8), ncs=(4, 4)),
    "border_b1_3": dict(seed=2, N=1, H=8, W=8, cnc=2, hids=(8,), ncs=(4,),
                        b1_value=3.0),
}


@pytest.mark.parametrize("case", sorted(SPADE_CASES))
def test_spade_cond_plain_matches_jax_kernel(case):
    seg, k1, b1, branches = _spade_case(**SPADE_CASES[case])
    want = jax_spade_cond(jnp.asarray(seg), jnp.asarray(k1), jnp.asarray(b1),
                          [tuple(map(jnp.asarray, b)) for b in branches],
                          interpret=True)
    t = torch.from_numpy
    got = spade_cond_plain(t(seg), t(k1), t(b1),
                           [tuple(map(t, b)) for b in branches])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_masked_blend_plain_matches_jax_kernel():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, 32, 128, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, (2, 32, 128, 3)).astype(np.float32)
    m = rng.uniform(0, 1, (2, 32, 128, 1)).astype(np.float32)
    want = np.asarray(jax_masked_blend(x, fake, m))
    got = masked_blend_plain(torch.from_numpy(x), torch.from_numpy(fake),
                             torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    reset_launches()
    seg, k1, b1, branches = _spade_case(**SPADE_CASES["dual"])
    t = torch.from_numpy
    outs = spade_cond(t(seg), t(k1), t(b1), [tuple(map(t, b)) for b in branches])
    want = spade_cond_plain(t(seg), t(k1), t(b1),
                            [tuple(map(t, b)) for b in branches])
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
    g = torch.Generator().manual_seed(8)
    x, fake, m = (torch.rand(1, 4, 4, c, generator=g) for c in (3, 3, 1))
    assert torch.equal(masked_blend(x, fake, m), masked_blend_plain(x, fake, m))
    assert launches == dict.fromkeys(launches, 0)


def test_spade_cond_rejects_mixed_devices_and_dtypes_before_launch():
    seg, k1, b1, branches = _spade_case(**SPADE_CASES["single"])
    t = torch.from_numpy
    with pytest.raises(ValueError):
        _check(t(seg), t(k1).double(), t(b1), [tuple(map(t, b)) for b in branches])


# the existing cases plus one at the painter's width (hid 128, nc 20, 8x16)
PACK_CASES = {**SPADE_CASES,
              "hid128_nc20": dict(seed=3, N=1, H=8, W=16, cnc=3, hids=(128,),
                                  ncs=(20,))}


def _jax_spade(seg, k1, b1, branches, dtype=jnp.float32):
    return jax_spade_cond(jnp.asarray(seg, dtype), jnp.asarray(k1, dtype),
                          jnp.asarray(b1, dtype),
                          [tuple(jnp.asarray(a, dtype) for a in b)
                           for b in branches], interpret=True)


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_spade_cond_packed_plain_matches_jax_kernel(case):
    """The bf16 kernel's packed layout, read back by its plain version in
    f32, against the Pallas kernel in interpret mode (2e-5, as above)."""
    seg, k1, b1, branches = _spade_case(**PACK_CASES[case])
    t = torch.from_numpy
    pack = pack_spade_cond(t(k1), t(b1), [tuple(map(t, b)) for b in branches],
                           route="wgmma")
    got = spade_cond_packed_plain(t(seg), pack)
    want = _jax_spade(seg, k1, b1, branches)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_spade_cond_packed_plain_bf16_matches_jax_kernel():
    """bf16 inputs: both round the activation to bf16 before the second
    conv and the output once; within one bf16 ulp of the output scale."""
    seg, k1, b1, branches = _spade_case(**PACK_CASES["hid128_nc20"])
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    pack = pack_spade_cond(bf(k1), bf(b1), [tuple(map(bf, b)) for b in branches])
    assert pack.route == "wgmma"
    (got,) = spade_cond_packed_plain(bf(seg), pack)
    (want,) = _jax_spade(seg, k1, b1, branches, jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


def _main_path_calls(cfg: GenConfig, size: int = 640):
    """(H, W, ncs) of each spade_cond launch of the painter, in order."""
    nc, n_up = cfg.p_latent_dim, cfg.p_spade_n_up
    s = size // 2 ** n_up
    blocks = [(nc, nc, s), (nc, nc, 2 * s), (nc, nc, 4 * s)]
    blocks += [(nc // 2 ** i, nc // 2 ** (i + 1), 8 * s * 2 ** i)
               for i in range(n_up - 2)]
    fin = nc // 2 ** (n_up - 2)
    blocks.append((fin, fin, size))
    calls = []
    for fin, fout, hw in blocks:
        calls.append((hw, hw, (fin, fin) if fin != fout else (fin,)))
        calls.append((hw, hw, (min(fin, fout),)))
    return calls


def test_n_split_covers_every_channel_once_on_the_main_path():
    calls = _main_path_calls(GenConfig())
    assert len(calls) == 18
    assert (640, 640, (40, 40)) in calls and (5, 5, (640,)) in calls
    for H, W, ncs in calls:
        couts = [2 * nc for nc in ncs]
        nt = chunk_width(couts)
        chunks = [-(-c // nt) for c in couts]
        group = plan_groups(2, H, W, chunks)
        blocks = block_chunks(chunks, group)
        assert 2 * len(blocks) <= 65535
        seen = [np.zeros(c, int) for c in couts]
        for b, c0, c1 in blocks:
            assert 0 <= c0 < c1 <= chunks[b] and c1 - c0 <= group
            seen[b][c0 * nt:c1 * nt] += 1
        assert all((s == 1).all() for s in seen), (H, W, ncs)
        if H == 640:
            assert nt in couts and group == 1  # unpadded N, one chunk a block


def test_painter_launches_run_on_packs_built_once(monkeypatch):
    """pack_spade_weights gives each spade_cond launch of a forward its own
    pack, built before the forward; the forward packs nothing."""
    from climategan_torch.models import norms
    from climategan_torch.models.blocks import pack_spade_weights
    from climategan_torch.models.painter import PainterSpadeDecoder

    torch.manual_seed(0)
    painter = PainterSpadeDecoder(latent_dim=16, spade_n_up=3).eval()
    pack_spade_weights(painter)
    built = {id(p) for m in painter.modules()
             for p in (getattr(m, "pack", None), getattr(m, "shortcut_pack", None))
             if p is not None}
    used = []
    run = norms.spade_cond_packed
    monkeypatch.setattr(norms, "spade_cond_packed",
                        lambda seg, pack: used.append(id(pack)) or run(seg, pack))
    monkeypatch.setattr(norms, "pack_spade_cond", None)  # a forward may not pack
    with torch.no_grad():
        out = painter(torch.rand(1, 3, 32, 32))
    assert out.shape == (1, 3, 32, 32)
    assert len(used) == 10 and set(used) == built


def test_packs_follow_the_model_across_a_cast():
    """eval() before a cast leaves no stale pack: the first eval forward
    packs in the weights' current dtype and keeps the packs (they are made
    outside inference mode, so a later forward with autograd on can use
    them), and a later cast packs again in the new dtype."""
    from climategan_torch.models.blocks import pack_spade_weights
    from climategan_torch.models.norms import init_weights
    from climategan_torch.models.painter import PainterSpadeDecoder

    def packs(model):
        return [p for m in model.modules()
                for p in (getattr(m, "pack", None),
                          getattr(m, "shortcut_pack", None)) if p is not None]

    painter = PainterSpadeDecoder(latent_dim=16, spade_n_up=3)
    init_weights(painter, torch.Generator().manual_seed(0))
    painter.eval()
    assert packs(painter) == []
    painter.to(torch.bfloat16)
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = painter(x.bfloat16())
    first = packs(painter)
    assert len(first) == 10
    assert all(p.args[0].dtype == torch.bfloat16 for p in first)
    assert not any(p.w1.is_inference() for p in first)
    with torch.no_grad():
        again = painter(x.bfloat16())
    assert [id(p) for p in packs(painter)] == [id(p) for p in first]
    pack_spade_weights(painter)  # packed up front: the same output
    with torch.no_grad():
        torch.testing.assert_close(painter(x.bfloat16()), out, rtol=0, atol=0)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    painter.float()
    with torch.no_grad():
        painter(x)
    assert all(p.args[0].dtype == torch.float32 for p in packs(painter))
