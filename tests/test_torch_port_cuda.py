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
    # the SPADE mask decoder's conditioning (cond_nc 15 or 12: 16 channels
    # a window pixel in bf16): its first block's dual call at 80^2, its last
    # norm_1 at a ragged size, and cnc 9 and 16 at the layout's edges
    "mask_dual_c15": dict(N=2, H=80, W=80, cnc=15, hids=(128, 128),
                          ncs=(128, 128)),
    "mask_nc16_c15": dict(N=1, H=37, W=91, cnc=15, hids=(128,), ncs=(16,)),
    "mask_dual_c12": dict(N=1, H=40, W=40, cnc=12, hids=(128, 128),
                          ncs=(64, 64)),
    "c9_ragged": dict(N=1, H=13, W=21, cnc=9, hids=(128,), ncs=(20,)),
    "c16_ragged": dict(N=2, H=19, W=35, cnc=16, hids=(96,), ncs=(32,)),
}
BF16_CASES = ["head_0", "up_spade_dual", "skinny_nc20", "skinny_nc40",
              "skinny_dual", "hid_24", "mask_dual_c15", "mask_nc16_c15",
              "mask_dual_c12", "c9_ragged", "c16_ragged"]


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
    deep = _to(_spade_args(N=1, H=8, W=8, cnc=17, hids=(32,), ncs=(4,)), dev,
               torch.bfloat16)
    with pytest.raises(ValueError):  # the bf16 kernel takes cnc <= 16
        spade_cond(*deep)


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


# ---- serving: the CLI, the native library, render's launches ----------

def _serve_args(*flags):
    from climategan_torch.apply_events import parse_args

    return parse_args(["-i", ".", *flags])


def _render(images, args, infer=None):
    """render() with an in-memory writer: (batches, {(name, event): uint8})."""
    from climategan_torch.apply_events import render

    outs = {}

    def write(name, event, img):
        outs[(name, event)] = img.copy()

    return render(images, args, write, infer=infer), outs


def test_cli_f32_on_the_card_matches_the_cpu():
    """The full-width model, random weights from seed 0, at 256^2 in f32
    (--keep_ratio_128 keeps 256^2 photos at that size, --no_cloudy keeps
    the flood off the device's own random draws): flood and smog within 1
    LSB on >= 99.9% of values; the wildfire's green value is drawn from
    each device's generator, so it is held to its shape."""
    _device()
    rs = np.random.RandomState(0)
    images = [(f"im_{i}", rs.randint(0, 256, (256, 256, 3), np.uint8))
              for i in range(2)]
    got = {}
    for where in ("cuda", "cpu"):
        n, got[where] = _render(images, _serve_args(
            "--keep_ratio_128", "-b", "2", "--no_cloudy", "--device", where))
        assert n == 1 and len(got[where]) == 6
    for (name, event), want in got["cpu"].items():
        out = got["cuda"][(name, event)]
        assert out.shape == want.shape == (256, 256, 3) and out.dtype == np.uint8
        if event != "wildfire":
            lsb = np.abs(out.astype(int) - want.astype(int))
            within = (lsb <= 1).mean()
            print(f"{name} {event}: within 1 LSB on {100 * within:.4f}%")
            assert within >= 0.999, (name, event, within)


def test_spade_masker_infer_on_the_card_matches_the_cpu():
    """The SPADE mask decoder (gen.m.use_spade, the default cond_nc 15 at
    full width; its conditioning through spade_cond at cnc 15), random
    weights from seed 0, at 256^2 in f32 with all three events and the same
    draws on both devices: the smooth masks within atol 1e-3, each event
    within 1 LSB on >= 99.9% of values."""
    from climategan_torch.inference import build_infer_fn
    from climategan_torch.utils.opts import load_opts

    _device()
    opts = load_opts(commandline_opts=["gen.m.use_spade=true"])
    x = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    uniform = torch.rand(9, 9, generator=torch.Generator().manual_seed(3))
    out = {}
    for where in ("cuda", "cpu"):
        _, infer = build_infer_fn(opts, dtype=torch.float32, bin_value=-1,
                                  device=where, seed=0)
        reset_launches()
        out[where] = {k: v.cpu() for k, v in
                      infer(x, uniform=uniform, g_value=120.0).items()}
        if where == "cuda":
            assert launches["spade_cond"] == 18 + 6
    err = (out["cuda"]["mask"] - out["cpu"]["mask"]).abs().max().item()
    print(f"mask: max abs error {err:.3e}")
    assert err <= 1e-3
    for event in ("flood", "wildfire", "smog"):
        lsb = (out["cuda"][event].int() - out["cpu"][event].int()).abs()
        within = (lsb <= 1).float().mean().item()
        print(f"{event}: within 1 LSB on {100 * within:.4f}%")
        assert within >= 0.999, (event, within)


def test_native_builds_from_a_clean_build_dir(tmp_path, monkeypatch):
    from climategan_torch.utils import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.available()
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [native.target().name]
    img = np.arange(256, dtype=np.uint8).reshape(8, 32, 1).repeat(3, -1)
    want = img.astype(np.float32) / np.float32(127.5) - np.float32(1)
    assert np.array_equal(native.pack_uint8_to_m11(img), want)
    assert native.prepare_inference(img, 8).shape == (8, 8, 3)


def test_render_launches_each_kernel_per_batch():
    """3 photos at -b 2 in bf16: two batches (the second padded), each the
    main path's 18 spade_cond and one launch of each other kernel; 9
    outputs."""
    from climategan_torch.apply_events import load_model

    _device()
    rs = np.random.RandomState(1)
    images = [(f"im_{i}", rs.randint(0, 256, (480, 640, 3), np.uint8))
              for i in range(3)]
    args = _serve_args("-b", "2", "--half")
    infer = load_model(args)
    reset_launches()
    n, outs = _render(images, args, infer)
    assert n == 2
    assert launches == {"spade_cond": 36, "masked_blend": 2, "smog_tail": 2,
                        "fire_color_grade": 2, "fire_paste": 2}
    assert len(outs) == 9
    assert all(v.shape == (640, 640, 3) and v.dtype == np.uint8
               for v in outs.values())


# ---- training (the port's train step) -------------------------------------

def _tiny_train(device):
    from climategan_torch.bench_train import synthetic_batch
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import TINY_OVERRIDES, TINY_SIZE

    builder = StepBuilder(load_opts(commandline_opts=TINY_OVERRIDES))
    return builder, synthetic_batch(2, TINY_SIZE, 32, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_blend_gradient_matches_plain(dtype):
    """MaskedBlend (the kernel forward, the plain backward) against
    masked_blend_plain under autograd."""
    from climategan_torch.kernels.masked_blend import MaskedBlend

    dev = _device()
    g = torch.Generator(device=dev).manual_seed(3)
    ins = [torch.rand(2, 64, 96, c, device=dev, generator=g).to(dtype)
           for c in (3, 3, 1)]
    up = torch.randn(2, 64, 96, 3, device=dev, generator=g)
    want_in = [t.clone().requires_grad_() for t in ins]
    got_in = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad((masked_blend_plain(*want_in).float() * up).sum(),
                               want_in)
    reset_launches()
    out = MaskedBlend.apply(*got_in)
    assert launches["masked_blend"] == 1
    got = torch.autograd.grad((out.float() * up).sum(), got_in)
    for a, b in zip(got, want):
        bar = 1e-6 if dtype == torch.float32 else \
            b.float().abs().max().item() * 2.0 ** -8
        assert (a.float() - b.float()).abs().max().item() <= bar


def test_tiny_train_step_on_the_card_matches_the_cpu():
    """g_step at tiny sizes in f32, card (kernels) vs CPU (plain), from the
    same state: losses within 1e-4; G held leaf by leaf by
    ``step_check.hold_state`` (first moments, every value whose gradient is
    not rounding noise within 1e-6, >= 99.9% of values within 1e-6,
    batch-norm statistics and u/v within 1e-5); D's parameters unchanged
    and its u/v within 1e-5."""
    import copy

    from climategan_torch.utils.step_check import first_moments, hold_state

    dev = _device()
    builder, batch = _tiny_train("cpu")
    cpu = builder.init_state(seed=0, device="cpu")
    card = builder.state_for(copy.deepcopy(cpu.G).to(dev),
                             copy.deepcopy(cpu.D).to(dev))
    reset_launches()
    _, m_dev = builder.g_step(card, {d: {k: v.to(dev) for k, v in b.items()}
                                     for d, b in batch.items()},
                              draws=(0.05, False))
    assert launches["masked_blend"] == 1 and launches["spade_cond"] == 0
    _, m_cpu = builder.g_step(cpu, batch, draws=(0.05, False))
    for k, v in m_cpu.items():
        assert abs(float(m_dev[k]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-9, k
    print(hold_state(card.G, cpu.G.state_dict(), builder.g_lr,
                     first_moments(card.G, card.g_opt),
                     first_moments(cpu.G, cpu.g_opt), what="G"))
    hold_state(card.D, cpu.D.state_dict(), what="D")


def test_two_trainer_steps_on_the_card_match_the_cpu(tmp_path):
    """One epoch of Trainer.run_epoch at tiny sizes in f32 (4 samples per
    domain: 2 steps) on the card and on the CPU, from the same seed and the
    same batches. ``step_check.hold_state``'s bars are set for one g_step or
    d_step from one state (a d_step's G forward advances G's u/v from the
    weights its g_step moved, which carry the noise values' differences),
    so the CPU's losses and state after each half step are recorded, and
    the card's run is held to them after the same half step and then given
    the CPU's state before it goes on. Every half: losses within 1e-4
    relative. Step 1's g_step and d_step and step 2's d_step: hold_state.
    Step 2's g_step: its statistics and u/v within 1e-5 and at most 0.1%
    of G's values off by more than 1e-6 (hold_state's bars on them); its
    first moments are not held leaf by leaf, as two f32 conv
    implementations on the CPU (oneDNN on and off) put the mask decoder's
    2-7% apart there: its gradient has fallen to 4e-5..1.7e-4 of G's
    largest, just over the noise floor measured at step 1."""
    import copy
    import random

    from climategan_torch.trainer import Trainer
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import (
        STATS,
        TINY_OVERRIDES,
        first_moments,
        hold_state,
    )
    from tests.torch_port_common import TRANSFORMS, write_dataset

    dev = _device()
    lists = write_dataset(tmp_path / "data")
    trainers = {}
    for where in ("cpu", dev):
        opts = load_opts(commandline_opts=TINY_OVERRIDES)
        opts.data.files = {"base": "", **lists}
        opts.data.loaders = {"batch_size": 2, "num_workers": 0}
        opts.data.transforms = TRANSFORMS
        opts.train.lambdas.G.p.vgg = 0
        opts.output_path = str(tmp_path / str(where))
        random.seed(0)
        trainers[where] = Trainer(opts, device=where).setup(seed=0)
    cpu, card = trainers["cpu"], trainers[dev]
    after = []  # the CPU's losses and (G, D, g_opt, d_opt) after each half

    def recorded(real):
        def half(state, *a, **k):
            state, metrics = real(state, *a, **k)
            after.append(({k: float(v) for k, v in metrics.items()},
                          copy.deepcopy((state.G.state_dict(),
                                         state.D.state_dict(), state.g_opt,
                                         state.d_opt))))
            return state, metrics
        return half

    def values_and_stats(got, want, what):
        sd = got.state_dict()
        params = dict(got.named_parameters())
        off = total = 0
        for k, v in sd.items():
            d = (v.float().cpu() - want[k].float()).abs()
            if k.rsplit(".", 1)[-1] in STATS:
                assert d.max().item() <= 1e-5, (what, k)
            elif k in params:
                off += int((d > 1e-6).sum())
                total += d.numel()
        assert off <= 1e-3 * total, (what, off, total)
        print(f"{what}: statistics and u/v within 1e-5; {off} of {total} "
              "values off by more than 1e-6")

    def held(real, stepped, other, lr):
        def half(state, *a, **k):
            state, metrics = real(state, *a, **k)
            losses, want = after.pop(0)
            for key, v in losses.items():
                assert abs(float(metrics[key]) - v) <= 1e-4 * abs(v) + 1e-9, key
            G, D, g_opt, d_opt = want
            sd = {"G": G, "D": D}
            module = getattr(state, stepped)
            what = f"step {state.step + (stepped == 'G')} {real.__name__}"
            if what == "step 2 g_step":
                values_and_stats(module, sd[stepped], f"{what} {stepped}")
            else:
                opt = {"G": g_opt, "D": d_opt}[stepped]
                print(hold_state(module, sd[stepped], lr,
                                 first_moments(module, getattr(
                                     state, f"{stepped.lower()}_opt")),
                                 first_moments(module, opt),
                                 what=f"{what} {stepped}"))
            hold_state(getattr(state, other), sd[other],
                       what=f"{what} {other}")
            state.G.load_state_dict(G)
            state.D.load_state_dict(D)
            state.g_opt, state.d_opt = (
                {k: ([t.to(dev) for t in v] if isinstance(v, (list, tuple))
                     else v) for k, v in o.items()} for o in want[2:])
            return state, metrics
        return half

    for name, stepped, other, lr in (("g_step", "G", "D", cpu.builder.g_lr),
                                     ("d_step", "D", "G", cpu.builder.d_lr)):
        setattr(cpu.builder, name, recorded(getattr(cpu.builder, name)))
        setattr(card.builder, name, held(getattr(card.builder, name),
                                         stepped, other, lr))
    random.seed(1)
    cpu.run_epoch()
    assert len(after) == 4
    random.seed(1)
    reset_launches()
    card.run_epoch()
    assert launches["masked_blend"] == 4 and launches["spade_cond"] == 0
    assert not after
    assert card.state.step == cpu.state.step == 2


def test_eval_after_a_train_step_on_the_card_serves_the_trained_weights():
    """After a step, eval() re-bakes the spectral kernels and re-packs the
    SPADEs on the card: the forward (with spade_cond and masked_blend)
    equals a fresh load of the trained weights, and differs from the
    untrained model's."""
    from climategan_torch.models.generator import OmniGenerator

    dev = _device()
    builder, batch = _tiny_train(dev)
    state = builder.init_state(seed=0, device=dev)
    untrained = OmniGenerator(state.G.cfg)
    untrained.load_state_dict(state.G.state_dict())
    state, _ = builder.train_step(state, batch)
    G = state.G.eval()
    fresh = OmniGenerator(G.cfg)
    fresh.load_state_dict(G.state_dict())
    fresh = fresh.to(dev).eval()
    untrained = untrained.to(dev).eval()
    x = batch["r"]["x"]
    m = (x[:, :1] > 0).float()
    with torch.no_grad():
        reset_launches()
        a = G.paint(m, x)
        assert launches["spade_cond"] > 0 and launches["masked_blend"] == 1
        torch.testing.assert_close(a, fresh.paint(m, x), rtol=0, atol=0)
        for u, v in zip(G.infer_masker(x), fresh.infer_masker(x)):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
        assert not torch.equal(a, untrained.paint(m, x))


REFUSED = {
    "train.grad_accumulation=2": "ROADMAP A.8 remainder",
    "tpu.remat=true": "ROADMAP A.8 remainder",
    "tpu.remat_d=true": "ROADMAP A.8 remainder",
    "dis.p.use_local_discriminator=true": "ROADMAP A.8 remainder",
    "gen.m.use_pl4m=true": "ROADMAP A.8 remainder",
    "dis.m.gan_type=WGAN_gp": "ROADMAP A.8 remainder",
    "dis.s.gan_type=WGAN_gp": "ROADMAP A.8 remainder",
    "gen.p.diff_aug.use=true": "ROADMAP A.8 remainder",
}


@pytest.mark.parametrize("override", sorted(REFUSED))
def test_step_builder_refuses_what_is_not_ported(override):
    """Each option whose branch of the JAX step is not ported raises a
    ValueError naming its ROADMAP item (no card needed)."""
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts

    with pytest.raises(ValueError, match=REFUSED[override]):
        StepBuilder(load_opts(commandline_opts=[override]))


@pytest.mark.parametrize("override", ["gen.m.use_spade=true",
                                      "gen.d.classify.enable=true",
                                      "gen.d.loss=dada"])
def test_step_builder_builds_it(override):
    """The options ported with the other generator configurations build
    a step (no card needed): the SPADE mask decoder, depth classification
    and the dada depth loss."""
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts

    builder = StepBuilder(load_opts(commandline_opts=[override]))
    key = override.split("=")[0]
    assert {"gen.m.use_spade": builder.cfg.m_use_spade,
            "gen.d.classify.enable": builder.cfg.d_classify,
            "gen.d.loss": builder.cfg.d_loss == "dada"}[key]


def test_step_builder_takes_the_ported_options():
    """hinge, WGAN clipping, pseudo-label tasks and lr groups build."""
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts

    builder = StepBuilder(load_opts(commandline_opts=[
        "gen.p.loss=hinge", "dis.m.gan_type=WGAN",
        "gen.opt.lr={default: 0.0001, p: 0.00005}"]))
    assert builder.cfg.p_loss == "hinge" and builder.g_lr_rules == {"painter": 0.5}
