"""The port's kernels on a CUDA card vs their plain PyTorch versions.

Every test is marked ``cuda`` and skips without a card. This file imports
no JAX, so it runs on a machine without it; tests/conftest.py does import
JAX, so run it there with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from climategan_torch.kernels import launches, reset_launches
from climategan_torch.kernels.masked_blend import masked_blend, masked_blend_plain
from climategan_torch.kernels.spade_cond import spade_cond, spade_cond_plain

pytestmark = pytest.mark.cuda

SPADE_CASES = {
    "single": dict(N=2, H=32, W=48, cnc=3, hids=(16,), ncs=(8,)),
    "dual": dict(N=1, H=16, W=32, cnc=3, hids=(16, 8), ncs=(4, 4)),
    "border_b1_3": dict(N=1, H=8, W=8, cnc=2, hids=(8,), ncs=(4,), b1=3.0),
    "ragged_tiles": dict(N=1, H=13, W=21, cnc=3, hids=(128,), ncs=(20,)),
    "head_0": dict(N=2, H=5, W=5, cnc=3, hids=(128,), ncs=(640,)),
    "up_spade_dual": dict(N=1, H=40, W=40, cnc=3, hids=(128, 128),
                          ncs=(160, 160)),
}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (with nvcc and triton)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spade_args(N, H, W, cnc, hids, ncs, b1=None, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g) * 0.3

    bias = torch.full((sum(hids),), b1) if b1 is not None else r(sum(hids))
    branches = [(r(3, 3, h, nc) / np.sqrt(h), r(nc), r(3, 3, h, nc) / np.sqrt(h),
                 r(nc)) for h, nc in zip(hids, ncs)]
    return r(N, H, W, cnc), r(3, 3, cnc, sum(hids)), bias, branches


def _to(args, dev, dtype):
    seg, k1, b1, branches = args
    return (seg.to(dev, dtype), k1.to(dev, dtype), b1.to(dev, dtype),
            [tuple(t.to(dev, dtype) for t in b) for b in branches])


@pytest.mark.parametrize("case", sorted(SPADE_CASES))
def test_spade_cond_f32_matches_plain(case):
    dev = _device()
    args = _to(_spade_args(**SPADE_CASES[case]), dev, torch.float32)
    reset_launches()
    got = spade_cond(*args)
    torch.cuda.synchronize()
    assert launches["spade_cond"] == 1
    for g, w in zip(got, spade_cond_plain(*args)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["head_0", "up_spade_dual"])
def test_spade_cond_bf16_within_one_ulp_of_f32_plain(case):
    """bf16 in, f32 sums, bf16 out: against the f32 plain version on the
    same bf16 inputs, the error is the output's own rounding (half a bf16
    ulp) plus f32 reordering; the bar is one ulp of the output scale."""
    dev = _device()
    args = _to(_spade_args(**SPADE_CASES[case]), dev, torch.bfloat16)
    got = spade_cond(*args)
    ref = spade_cond_plain(*_to(args, dev, torch.float32))
    for g, w in zip(got, ref):
        ulp = 2.0 ** (torch.floor(torch.log2(w.abs().max())) - 7)
        assert (g.float() - w).abs().max() <= ulp


def test_spade_cond_rejects_what_it_does_not_take():
    dev = _device()
    seg, k1, b1, branches = _to(_spade_args(**SPADE_CASES["single"]), dev,
                                torch.float32)
    with pytest.raises(ValueError):
        spade_cond(seg, k1, b1.cpu(), branches)
    with pytest.raises(ValueError):
        spade_cond(seg[:, :, ::2], k1, b1, branches)
    with pytest.raises(TypeError):
        spade_cond(seg.half(), k1.half(), b1.half(),
                   [tuple(t.half() for t in b) for b in branches])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_blend_matches_plain(dtype):
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(1)
    x, fake, m = (torch.rand(2, 40, 72, c, device=dev, generator=g).to(dtype)
                  for c in (3, 3, 1))
    reset_launches()
    got = masked_blend(x, fake, m)
    torch.cuda.synchronize()
    assert launches["masked_blend"] == 1
    torch.testing.assert_close(got, masked_blend_plain(x, fake, m), rtol=0,
                               atol=1e-6)
