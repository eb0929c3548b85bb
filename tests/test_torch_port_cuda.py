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
from climategan_torch.kernels.fire_color_grade import (
    fire_color_grade,
    fire_color_grade_plain,
)
from climategan_torch.kernels.fire_paste import fire_paste, fire_paste_plain
from climategan_torch.kernels.masked_blend import masked_blend, masked_blend_plain
from climategan_torch.kernels.smog_tail import smog_tail, smog_tail_plain
from climategan_torch.kernels.spade_cond import (
    pack_spade_cond,
    spade_cond,
    spade_cond_packed,
    spade_cond_plain,
)
from tests.torch_port_common import (
    GRADE_MEANS,
    grade_edge_planes,
    smog_edge_planes,
)

pytestmark = pytest.mark.cuda

SPADE_CASES = {
    "single": dict(N=2, H=32, W=48, cnc=3, hids=(16,), ncs=(8,)),
    "dual": dict(N=1, H=16, W=32, cnc=3, hids=(16, 8), ncs=(4, 4)),
    "border_b1_3": dict(N=1, H=8, W=8, cnc=2, hids=(8,), ncs=(4,), b1=3.0),
    "ragged_tiles": dict(N=1, H=13, W=21, cnc=3, hids=(128,), ncs=(20,)),
    "head_0": dict(N=2, H=5, W=5, cnc=3, hids=(128,), ncs=(640,)),
    "up_spade_dual": dict(N=1, H=40, W=40, cnc=3, hids=(128, 128),
                          ncs=(160, 160)),
    # the painter's skinny 640^2 widths at a ragged size, and a hid that
    # the bf16 kernel pads (24 -> 32)
    "skinny_nc20": dict(N=2, H=37, W=91, cnc=3, hids=(128,), ncs=(20,)),
    "skinny_nc40": dict(N=2, H=37, W=91, cnc=3, hids=(128,), ncs=(40,)),
    "skinny_dual": dict(N=2, H=37, W=91, cnc=3, hids=(128, 128),
                        ncs=(40, 40)),
    "hid_24": dict(N=1, H=20, W=33, cnc=3, hids=(24,), ncs=(20,)),
}
BF16_CASES = ["head_0", "up_spade_dual", "skinny_nc20", "skinny_nc40",
              "skinny_dual", "hid_24"]


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


@pytest.mark.parametrize("case", BF16_CASES)
def test_spade_cond_bf16_within_one_ulp_of_f32_plain(case):
    """bf16 in, f32 sums, the activation and the output rounded to bf16 (the
    tensor-core kernel, one launch): against the f32 plain version on the
    same bf16 inputs the error is the output's own rounding (half a bf16
    ulp) plus the activation's; the bar is one ulp of the output scale.
    head_0 (nc 640 at 5x5, batch 2) runs as N-split chunks."""
    dev = _device()
    args = _to(_spade_args(**SPADE_CASES[case]), dev, torch.bfloat16)
    reset_launches()
    got = spade_cond(*args)
    torch.cuda.synchronize()
    assert launches["spade_cond"] == 1
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
    f32_pack = pack_spade_cond(k1, b1, branches)
    with pytest.raises(ValueError):  # a bf16 seg needs a "wgmma" pack
        spade_cond_packed(seg.bfloat16(), f32_pack)
    wide = _to(_spade_args(N=1, H=8, W=8, cnc=3, hids=(160,), ncs=(4,)), dev,
               torch.bfloat16)
    with pytest.raises(ValueError):  # the bf16 kernel takes hid <= 128
        spade_cond(*wide)


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


# (2, 37, 91), (1, 3, 5) and (3, 1, 3): H*W not a multiple of 4 (smog_tail's
# scalar path, whose runs of 4 pixels cross into the next image, at
# (3, 1, 3) in every run; fire_color_grade's ragged tail); (2, 64, 128):
# the vector paths; (2, 640, 640): the main path's size; (2, 1024, 1024):
# more work than one wave of the grid sized to the card, so its grid-stride
# loop turns more than once
EVENT_SHAPES = [(2, 37, 91), (1, 3, 5), (3, 1, 3), (2, 64, 128),
                (2, 640, 640), (2, 1024, 1024)]
SMOG = dict(airlight=0.76, beta=2.0, yellow=(224.0, 192.0, 29.0), alpha=20.0)


def _event_args(name, dev, shape, seed=2):
    """The kernel, its plain version and float32 inputs on ``dev``: x in
    [0, 1] for smog_tail, integers in [0, 255] (as after the warm shift)
    for the fire kernels."""
    g = torch.Generator().manual_seed(seed)
    N, H, W = shape
    plane = torch.rand(N, 1, H, W, generator=g)
    if name == "smog_tail":
        x = torch.rand(N, 3, H, W, generator=g)
        return smog_tail, smog_tail_plain, [x.to(dev), plane.to(dev)], SMOG
    x = torch.floor(torch.rand(N, 3, H, W, generator=g) * 256)
    if name == "fire_color_grade":
        return (fire_color_grade, fire_color_grade_plain,
                [x.to(dev), torch.tensor(97.3, device=dev)], {})
    return (fire_paste, fire_paste_plain,
            [x.to(dev), plane.to(dev), torch.tensor(131.0, device=dev)], {})


@pytest.mark.parametrize("shape", EVENT_SHAPES)
@pytest.mark.parametrize("name", ["smog_tail", "fire_color_grade", "fire_paste"])
def test_event_kernel_matches_plain(name, shape):
    """smog_tail within atol 1e-5; the fire kernels within 1.0 and equal on
    >= 99.99% of values (chip_smoke.py's bars); one launch each."""
    dev = _device()
    kernel, plain, args, kw = _event_args(name, dev, shape)
    reset_launches()
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert launches[name] == 1
    assert sum(launches.values()) == 1
    _hold_to_plain(name, got, plain(*args, **kw))


def _hold_to_plain(name, got, want):
    if name == "smog_tail":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        diff = (got - want).abs()
        assert diff.max() <= 1.0
        assert (diff == 0).float().mean() >= 0.9999


def _misaligned(t, layout):
    """t's values in a contiguous tensor whose base is not 16-byte aligned:
    ``batch_slice`` is t[1:] of a batch one image larger (a base 3*H*W
    floats on, with H*W not a multiple of 4); ``offset_by_one`` lies one
    float past an aligned base."""
    if layout == "batch_slice":
        return torch.cat([t[:1], t])[1:]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("layout,shape", [("batch_slice", (2, 37, 91)),
                                          ("offset_by_one", (2, 64, 128))])
@pytest.mark.parametrize("name", ["smog_tail", "fire_color_grade", "fire_paste"])
def test_event_kernel_takes_a_misaligned_base(name, layout, shape):
    """The scalar paths of the redesigned kernels: every (N, C, H, W) input
    starts off a 16-byte boundary (the output, from the wrapper, does not)."""
    dev = _device()
    kernel, plain, args, kw = _event_args(name, dev, shape)
    args = [_misaligned(a, layout) if a.ndim == 4 else a for a in args]
    assert all(a.data_ptr() % 16 for a in args if a.ndim == 4)
    reset_launches()
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert launches[name] == 1
    _hold_to_plain(name, got, plain(*args, **kw))


@pytest.mark.parametrize("layout", ["aligned", "offset_by_one"])
def test_smog_tail_at_its_branch_points(layout):
    """smog_edge_planes() through the vector path and the scalar path:
    within atol 1e-5 of the plain version, so a linear value at 0.0031308
    takes the plain version's side of the curve's 2.5e-5 step."""
    dev = _device()
    x, d = (torch.from_numpy(a).to(dev) for a in smog_edge_planes())
    if layout != "aligned":
        x, d = _misaligned(x, layout), _misaligned(d, layout)
    got = smog_tail(x, d, **SMOG)
    torch.testing.assert_close(got, smog_tail_plain(x, d, **SMOG), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("mean", GRADE_MEANS)
def test_fire_color_grade_at_its_floor_steps_and_clamps(mean):
    dev = _device()
    x = torch.from_numpy(grade_edge_planes()).to(dev)
    m = torch.tensor(mean, device=dev)
    _hold_to_plain("fire_color_grade", fire_color_grade(x, m, 1.5, 0.73),
                   fire_color_grade_plain(x, m, 1.5, 0.73))


def test_smog_tail_gamma_sweep():
    """The 2^20 float32 values k / 2^20 in every channel, with d = 0 (the
    decode and encode round trip) and d = 1: within atol 1e-5 of the plain
    version; the largest error prints under ``-s``."""
    dev = _device()
    grid = torch.arange(2 ** 20, device=dev, dtype=torch.float32) / 2 ** 20
    x = grid.view(1, 1, 1024, 1024).expand(2, 3, -1, -1).contiguous()
    d = torch.cat([torch.zeros(1, 1, 1024, 1024, device=dev),
                   torch.ones(1, 1, 1024, 1024, device=dev)])
    err = (smog_tail(x, d, **SMOG) - smog_tail_plain(x, d, **SMOG)).abs()
    print(f"smog_tail gamma sweep, 2^20 values: max abs error "
          f"{err.max().item():.3e} (d = 0: {err[0].max().item():.3e}, "
          f"d = 1: {err[1].max().item():.3e})")
    assert err.max().item() <= 1e-5


@pytest.mark.parametrize("name", ["smog_tail", "fire_color_grade", "fire_paste"])
def test_event_kernel_rejects_what_it_does_not_take(name):
    dev = _device()
    kernel, _, args, kw = _event_args(name, dev, (1, 8, 16))
    x, rest = args[0], args[1:]
    reset_launches()
    with pytest.raises(TypeError):
        kernel(x.bfloat16(), *rest, **kw)
    with pytest.raises(ValueError):
        kernel(x[..., ::2], *[r[..., ::2] if r.ndim == 4 else r for r in rest],
               **kw)  # not contiguous
    with pytest.raises(ValueError):
        kernel(x, *[r.cpu() for r in rest], **kw)  # CPU beside CUDA
    with pytest.raises(ValueError):
        kernel(x.cpu(), *rest, **kw)  # CUDA beside CPU
    assert launches == dict.fromkeys(launches, 0)
