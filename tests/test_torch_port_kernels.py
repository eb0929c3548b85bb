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
from climategan_torch.kernels.spade_cond import _check, spade_cond, spade_cond_plain


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
