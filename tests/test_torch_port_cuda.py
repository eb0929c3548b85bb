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


def _tiny_dp_train():
    """The tiny step without a bicubic resize (``TINY_DP_OVERRIDES``,
    reproducible on the card), its batch on the CPU."""
    from climategan_torch.bench_train import synthetic_batch
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import (
        TINY_DP_DEPTH,
        TINY_DP_OVERRIDES,
        TINY_SIZE,
    )

    builder = StepBuilder(load_opts(path=TINY_DP_OVERRIDES))
    return builder, synthetic_batch(2, TINY_SIZE, 32, "cpu",
                                    depth=TINY_DP_DEPTH)


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


# the step's options (ported with the rest of the step; CPU tests against
# the JAX package: tests/test_torch_port_step_options.py)
DIFF_AUG = ["gen.p.diff_aug.use=true", "gen.p.diff_aug.do_color_jittering=true",
            "gen.p.diff_aug.do_cutout=true", "gen.p.diff_aug.do_translation=true"]
# option: (overrides, per-domain batch, masked_blend launches of g_step and
# of d_step: a paste per painter forward, pl4m's included, a rematerialized
# one twice)
STEP_OPTIONS = {
    "grad_accumulation": (["train.grad_accumulation=2"], 4, (2, 2)),
    "remat": (["tpu.remat=true"], 2, (2, 1)),
    "remat_d": (["tpu.remat_d=true", "tpu.remat_policy=dots"], 2, (1, 2)),
    "local_discriminator": (["dis.p.use_local_discriminator=true"], 2, (1, 1)),
    "pl4m": (["gen.m.use_pl4m=true"], 2, (2, 1)),
    "m_WGAN_gp": (["dis.m.gan_type=WGAN_gp"], 2, (1, 1)),
    "s_WGAN_gp": (["dis.s.gan_type=WGAN_gp"], 2, (1, 1)),
    "diff_aug": (DIFF_AUG, 2, (1, 1)),
}


@pytest.mark.parametrize("option", sorted(STEP_OPTIONS))
def test_step_option_on_the_card(option):
    """Each option's tiny g_step and d_step on the card against the CPU
    (f32, TF32 off; the CPU's convs with oneDNN off) from one state, with
    the same draws: every loss within 1e-4 relative; the G step launches
    masked_blend once per paste (pl4m's and the painter's, each
    micro-batch's, a rematerialized forward's again) and never
    spade_cond."""
    import copy

    from climategan_torch.bench_train import synthetic_batch
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import TINY_OVERRIDES, TINY_SIZE

    dev = _device()
    overrides, n, pastes = STEP_OPTIONS[option]
    builder = StepBuilder(load_opts(path=TINY_OVERRIDES,
                                    commandline_opts=overrides))
    cpu = builder.init_state(seed=0, device="cpu")
    card = builder.state_for(copy.deepcopy(cpu.G).to(dev),
                             copy.deepcopy(cpu.D).to(dev))
    batch = synthetic_batch(n, TINY_SIZE, 32, "cpu")
    batch_dev = {d: {k: v.to(dev) for k, v in b.items()}
                 for d, b in batch.items()}
    micro = {d: {k: v[:n // builder.grad_accumulation] for k, v in b.items()}
             for d, b in batch.items()}
    for i, (name, draws) in enumerate((("g_step", (0.05, False)),
                                       ("d_step", (0.1, False)))):
        aug = builder.aug_draws(cpu, micro)
        reset_launches()
        _, m_dev = getattr(builder, name)(card, batch_dev, draws=draws,
                                          aug=aug)
        torch.cuda.synchronize()
        assert launches["spade_cond"] == 0
        assert launches["masked_blend"] == pastes[i], (option, name)
        with torch.backends.mkldnn.flags(enabled=False):
            _, m_cpu = getattr(builder, name)(cpu, batch, draws=draws,
                                              aug=aug)
        assert set(m_dev) == set(m_cpu)
        for k, v in m_cpu.items():
            a, b = float(m_dev[k]), float(v)
            assert abs(a - b) <= 1e-4 * abs(b) + 1e-9, (option, name, k, a, b)
        card.G.load_state_dict(cpu.G.state_dict())
        card.D.load_state_dict(cpu.D.state_dict())


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


def _dp_jobs(builder):
    """A seed-0 state on the CPU and the g_step and d_step jobs of
    tests/torch_port_ranks.py:steps from it."""
    state = builder.init_state(seed=0, device="cpu")
    g_sd = {k: v.clone() for k, v in state.G.state_dict().items()}
    d_sd = {k: v.clone() for k, v in state.D.state_dict().items()}
    return state, [("g_step", g_sd, d_sd, {"draws": (0.05, False)}),
                   ("d_step", g_sd, d_sd, {"draws": (0.1, False)})]


def _one_process(builder, cpu, jobs, batch, dev):
    """Each job in this process on the card, on the whole batch."""
    import copy

    out = []
    for name, g_sd, d_sd, kwargs in jobs:
        G, D = copy.deepcopy(cpu.G), copy.deepcopy(cpu.D)
        G.load_state_dict(g_sd)
        D.load_state_dict(d_sd)
        state = builder.state_for(G.to(dev), D.to(dev))
        state, metrics = getattr(builder, name)(
            state, {d: {k: v.to(dev) for k, v in b.items()}
                    for d, b in batch.items()}, **kwargs)
        out.append((state, metrics))
    return out


def _deterministic(fn, *args):
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn(*args)
    finally:
        torch.use_deterministic_algorithms(False)


def test_nccl_at_world_one_steps_as_the_plain_step():
    """One NCCL rank (a process of its own) takes g_step and d_step through
    the data-parallel path at tiny sizes, PyTorch's deterministic
    algorithms on both sides: its states equal this process's plain
    steps' from the same state bit for bit."""
    from climategan_torch.parallel.spawn import run_ranks
    from climategan_torch.utils.checkpoint import checkpoint_dict, state_digest

    dev = _device()
    builder, batch = _tiny_dp_train()
    cpu, jobs = _dp_jobs(builder)
    want = [state_digest(checkpoint_dict(state, 0)) for state, _ in
            _deterministic(_one_process, builder, cpu, jobs, batch, dev)]
    torch.cuda.empty_cache()
    got = run_ranks("tests.torch_port_ranks:steps", 1,
                    {"opts": builder.opts, "batch": batch, "jobs": jobs,
                     "deterministic": True},
                    devices=["cuda:0"], backend="nccl", timeout=120)[0]
    assert [r["digest"] for r in got] == want


def test_two_gloo_ranks_on_one_card_step_as_one_process():
    """Two gloo ranks on cuda:0, one row of each domain per rank,
    deterministic algorithms on both sides: g_step and d_step
    from the seed-0 state held by ``hold_state`` against this process's
    steps on the global batch, losses within 1e-4, both ranks' states
    equal."""
    import copy

    from climategan_torch.parallel.spawn import run_ranks
    from climategan_torch.utils.step_check import first_moments, hold_state

    dev = _device()
    builder, batch = _tiny_dp_train()
    cpu, jobs = _dp_jobs(builder)
    want = _deterministic(_one_process, builder, cpu, jobs, batch, dev)
    torch.cuda.empty_cache()
    got = run_ranks("tests.torch_port_ranks:steps", 2,
                    {"opts": builder.opts, "batch": batch, "jobs": jobs,
                     "deterministic": True},
                    devices=["cuda:0", "cuda:0"], backend="gloo",
                    timeout=120)
    assert [r["digest"] for r in got[1]] == [r["digest"] for r in got[0]]
    for i, ((state, metrics), res) in enumerate(zip(want, got[0])):
        for k, v in metrics.items():
            assert abs(res["metrics"][k] - float(v)) <= \
                1e-4 * abs(float(v)) + 1e-9, k
        G, D = copy.deepcopy(state.G), copy.deepcopy(state.D)
        G.load_state_dict(res["G"])
        D.load_state_dict(res["D"])
        got_m, want_m = (G, D)[i], (state.G, state.D)[i]
        opt = (state.g_opt, state.d_opt)[i]
        print(hold_state(got_m, want_m.state_dict(),
                         (builder.g_lr, builder.d_lr)[i],
                         (res["g_mu"], res["d_mu"])[i],
                         first_moments(want_m, opt), what=jobs[i][0]))
        hold_state((D, G)[i], (state.D, state.G)[i].state_dict(),
                   what=f"{jobs[i][0]}, the other model")


# ---- row-sharded inference (parallel/spatial.py) ----------------------------

@pytest.mark.parametrize("H", [5, 13, 40, 81])
def test_spade_cond_kernel_on_halo_windows(H):
    """The kernels on the conditioning windows a row shard passes them:
    rows [lo - 2, hi + 2) of each shard's rows [lo, hi) over 2, 3 and 4
    shards, clipped to the image (heights that are not a multiple of the
    8-row tile, 1- and 2-row shards): f32 within 1e-4 of spade_cond_plain
    on the same window, and the cropped outputs equal the whole map's
    rows, f32 within 1e-4 of the plain version's and bf16 bit for bit the
    tensor-core kernel's own on the whole map (each output sums the same
    taps in the same order wherever its tile starts). The bf16 kernel's
    error against the f32 plain version on the whole map is printed."""
    _halo_windows(H, cnc=3, ncs=(40, 40))


@pytest.mark.parametrize("cnc", [15, 12])
@pytest.mark.parametrize("H", [5, 13, 40, 81])
def test_spade_cond_kernel_on_wide_halo_windows(H, cnc):
    """The same on the SPADE mask decoder's conditioning (cond_nc 15 or
    12: the bf16 kernel's 16-channel window pixel) at its widths (a dual
    call of two 128-wide hidden maps): the windows of 1-row shards and of
    fewer rows than the halo included."""
    _halo_windows(H, cnc=cnc, ncs=(128, 128))


def _halo_windows(H, cnc, ncs):
    from climategan_torch.kernels.spade_cond import pack_spade_cond
    from climategan_torch.parallel.spatial import split

    dev = _device()
    seg, k1, b1, branches = _to(_spade_args(N=2, H=H, W=40, cnc=cnc,
                                            hids=(128, 128), ncs=ncs),
                                dev, torch.float32)
    whole = spade_cond_plain(seg, k1, b1, branches)
    packs = {dt: pack_spade_cond(*_to((seg, k1, b1, branches), dev, dt)[1:])
             for dt in (torch.float32, torch.bfloat16)}
    whole16 = spade_cond_packed(seg.bfloat16(), packs[torch.bfloat16])
    ref = spade_cond_plain(*_to((seg.bfloat16(), k1, b1, branches), dev,
                                torch.float32))
    for g, w in zip(whole16, ref):
        ulp = 2.0 ** (torch.floor(torch.log2(w.abs().max())) - 7)
        err = (g.float() - w).abs().max()
        print(f"H {H}: bf16 whole map max error {err:.3e} (one ulp of the "
              f"scale {ulp:.3e})")
    for k in (2, 3, 4):
        for lo, hi in split(H, k):
            if lo == hi:
                continue
            wlo, whi = max(lo - 2, 0), min(hi + 2, H)
            win = seg[:, wlo:whi].contiguous()
            want = spade_cond_plain(win, k1, b1, branches)
            reset_launches()
            got = spade_cond_packed(win, packs[torch.float32])
            bf = spade_cond_packed(win.bfloat16(), packs[torch.bfloat16])
            torch.cuda.synchronize()
            assert launches["spade_cond"] == 2
            for g, w, full in zip(got, want, whole):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
                torch.testing.assert_close(g[:, lo - wlo:hi - wlo],
                                           full[:, lo:hi], rtol=1e-4,
                                           atol=1e-4)
            for g, full in zip(bf, whole16):
                assert torch.equal(g[:, lo - wlo:hi - wlo], full[:, lo:hi])


def test_spatial_forward_on_a_repeated_card_matches_the_unsharded():
    """The tiny model (64^2, f32, TF32 off) row-sharded over ["cuda:0"] *
    2 against its unsharded forward on the card: every event within 1 LSB
    on >= 99.9% of values, the mask within 1e-5; each kernel launched once
    per shard (spade_cond twice per SPADE block, 14 per shard with the
    tiny painter's 7 blocks: every shard has rows of every painter map)."""
    from climategan_torch.inference import (
        build_infer_fn,
        build_spatial_infer_fn,
    )
    from tests.torch_port_common import port_tiny_opts

    dev = _device()
    opts = port_tiny_opts(64)
    g = torch.Generator().manual_seed(4)
    x = (torch.rand((2, 64, 64, 3), generator=g) * 2 - 1).to(dev)
    u = torch.rand((9, 9), generator=g).to(dev)
    kw = dict(dtype=torch.float32, seed=3)
    want = build_infer_fn(opts, device=dev, **kw)[1](x, uniform=u,
                                                     g_value=120.0)
    _, infer = build_spatial_infer_fn(opts, ["cuda:0"] * 2, **kw)
    infer(x, uniform=u, g_value=120.0)
    reset_launches()
    got = infer(x, uniform=u, g_value=120.0)
    torch.cuda.synchronize()
    assert launches == {"spade_cond": 28, "masked_blend": 2, "smog_tail": 2,
                        "fire_color_grade": 2, "fire_paste": 2}
    for key in ("flood", "wildfire", "smog"):
        diff = (got[key].int() - want[key].int()).abs()
        print(f"{key}: max {diff.max().item()} LSB, "
              f"{100 * (diff == 0).float().mean().item():.4f}% equal")
        assert (diff <= 1).float().mean() >= 0.999, key
    torch.testing.assert_close(got["mask"], want["mask"], rtol=0, atol=1e-5)


# ---- row-sharded training (tpu.spatial_shards) ----------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_masked_blend_per_shard_forward_and_backward(dtype):
    """The paste of a row-sharded step: ``MaskedBlend`` on each shard of
    rows (7 rows over 3 shards: 2, 2, 3) of an NCHW map through
    ``generator.paste_rows``, one kernel launch a shard, against
    ``masked_blend_plain`` on the whole map under autograd: the outputs and
    the three gradients (f32 within 1e-6, bf16 one ulp of the largest,
    float64, which the kernel computes in float64, within 1e-12)."""
    from climategan_torch.models.generator import paste_rows
    from climategan_torch.parallel import spatial

    dev = _device()
    g = torch.Generator(device=dev).manual_seed(5)
    ins = [torch.rand(2, c, 7, 33, device=dev, generator=g).to(dtype)
           for c in (3, 3, 1)]
    up = torch.randn(2, 3, 7, 33, device=dev, generator=g).to(
        torch.promote_types(dtype, torch.float32))
    want_in = [t.clone().requires_grad_() for t in ins]
    got_in = [t.clone().requires_grad_() for t in ins]
    nhwc = [t.permute(0, 2, 3, 1) for t in want_in]
    want = masked_blend_plain(*nhwc).permute(0, 3, 1, 2)
    reset_launches()
    got = paste_rows(*(spatial.split_rows(t, [dev] * 3) for t in got_in))
    assert launches["masked_blend"] == 3
    got = got.gather(dev)
    want_g = torch.autograd.grad((want.float() * up).sum(), want_in)
    got_g = torch.autograd.grad((got.float() * up).sum(), got_in)
    for a, b in zip([got, *got_g], [want, *want_g]):
        bar = {torch.float32: 1e-6, torch.float64: 1e-12}.get(
            dtype, b.float().abs().max().item() * 2.0 ** -8)
        assert (a.double() - b.double()).abs().max().item() <= bar


def test_tiny_row_sharded_step_on_the_card_matches_the_cpu():
    """g_step and d_step over ["cuda:0"] * 2 (the tiny step without a
    bicubic resize, TINY_DP_OVERRIDES, deterministic algorithms) from the
    seed-0 state against the CPU's row-sharded steps over ["cpu"] * 2:
    losses within 1e-4, the stepped model held by ``hold_state``, the
    other's statistics and u/v; two masked_blend launches a step."""
    import copy

    from climategan_torch.utils.step_check import first_moments, hold_state

    dev = _device()
    builder, batch = _tiny_dp_train()
    cpu, jobs = _dp_jobs(builder)
    for name, g_sd, d_sd, kwargs in jobs:
        states = {}
        for where in ("cpu", dev):
            G, D = copy.deepcopy(cpu.G), copy.deepcopy(cpu.D)
            G.load_state_dict(g_sd)
            D.load_state_dict(d_sd)
            state = builder.state_for(G.to(where), D.to(where))
            reset_launches()
            on = {d: {k: v.to(where) for k, v in b.items()}
                  for d, b in batch.items()}
            states[where] = _deterministic(lambda: getattr(builder, name)(
                state, on, devices=[where] * 2, **kwargs))
            if where == dev:
                assert launches["masked_blend"] == 2
        (got, got_m), (want, want_m) = states[dev], states["cpu"]
        for k, v in want_m.items():
            assert abs(float(got_m[k]) - float(v)) <= \
                1e-4 * abs(float(v)) + 1e-9, (name, k)
        net = "G" if name == "g_step" else "D"
        opt = "g_opt" if net == "G" else "d_opt"
        lr = builder.g_lr if net == "G" else builder.d_lr
        print(hold_state(getattr(got, net),
                         getattr(want, net).state_dict(), lr,
                         first_moments(getattr(got, net), getattr(got, opt)),
                         first_moments(getattr(want, net),
                                       getattr(want, opt)),
                         what=f"{name} {net}"))
        other = "D" if net == "G" else "G"
        hold_state(getattr(got, other), getattr(want, other).state_dict(),
                   what=f"{name} {other}")


@pytest.mark.parametrize("sharded", [False, True])
def test_discriminator_pool_gradient_of_a_channels_last_input(sharded):
    """The painter D's pyramid pool (``avg_pool_3x3_s2``) on the paste's
    NHWC-strided output, whole and over 2 row shards: the input gradient
    equals the one of the same values in NCHW-contiguous memory (float64
    within 1e-12). PyTorch's CUDA backward of an overlapping average pool
    is wrong for a channels-last input; the port makes the input
    contiguous first."""
    from climategan_torch.models.discriminator import avg_pool_3x3_s2
    from climategan_torch.parallel import spatial

    dev = _device()
    x = torch.rand(2, 3, 32, 32, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    up = torch.rand(2, 3, 16, 16, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    grads = []
    for t in (x.clone(), x.permute(0, 2, 3, 1).contiguous().permute(
            0, 3, 1, 2)):
        t.requires_grad_(True)
        y = avg_pool_3x3_s2(spatial.split_rows(t, [dev] * 2) if sharded
                            else t)
        if sharded:
            y = y.gather(dev)
        grads.append(torch.autograd.grad((y * up).sum(), t)[0])
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-12


@pytest.mark.parametrize("shards", [1, 2])
def test_deeplab_v2_dropout_under_remat_on_the_card(shards):
    """DeepLab v2's g_step (tiny, float64) with tpu.remat under the
    ``small_convs`` policy against the same step without remat, unsharded
    and over ["cuda:0"] * 2, from one dropout seed: the recompute draws
    the forward's masks again (``train_step.remat_contexts`` restores the
    shards' CUDA generators, which ``checkpoint`` does not see in a
    row-sharded batch), so the losses agree within 1e-12 relative and G
    is held by ``hold_state``."""
    import copy

    from climategan_torch import bench_train
    from climategan_torch.train_step import StepBuilder
    from climategan_torch.utils.opts import load_opts
    from climategan_torch.utils.step_check import (
        TINY_OVERRIDES,
        TINY_SIZE,
        first_moments,
        hold_state,
    )

    dev = _device()
    overrides = ["gen.encoder.architecture=deeplabv2",
                 "gen.s.architecture=deeplabv2"]
    batch = {d: {k: v.double() if v.is_floating_point() else v
                 for k, v in b.items()}
             for d, b in bench_train.synthetic_batch(
                 2, TINY_SIZE, 32, dev).items()}
    devices = None if shards == 1 else ["cuda:0"] * shards
    first, runs = None, []
    for remat in ([], ["tpu.remat=true", "tpu.remat_policy=small_convs"]):
        builder = StepBuilder(load_opts(path=TINY_OVERRIDES,
                                        commandline_opts=overrides + remat))
        if first is None:
            first = builder.init_state(0, dev)
            first.G, first.D = first.G.double(), first.D.double()
        state = builder.state_for(copy.deepcopy(first.G),
                                  copy.deepcopy(first.D))
        torch.manual_seed(3)
        state, metrics = builder.g_step(state, batch, draws=(0.05, False),
                                        devices=devices)
        runs.append((state, metrics, first_moments(state.G, state.g_opt)))
    (want, want_m, want_mu), (got, got_m, got_mu) = runs
    for k, v in want_m.items():
        assert abs(float(got_m[k]) - float(v)) <= \
            1e-12 * abs(float(v)) + 1e-15, k
    print(hold_state(got.G, want.G.state_dict(), builder.g_lr, got_mu,
                     want_mu, what=f"remat, {shards} shard(s)"))


def test_profiler_puts_every_spade_cond_kernel_in_a_painter_stage(tmp_path):
    """climategan_torch.profile_inference on one tiny forward (the tiny
    opts below 128^2): every spade_cond kernel in the trace is linked to a
    painter/* stage, as many as the wrapper launched, and the stages sum
    to the device total within 1%."""
    from climategan_torch import profile_inference

    _device()
    res = profile_inference.run(profile_inference.parse_args([
        "--size", "64", "--batch", "1", "--iters", "1", "--events", "all",
        "--out", str(tmp_path)]))
    spade = [stage for name, stage, _ in res["rows"] if "spade_cond" in name]
    assert len(spade) == res["launches"]["spade_cond"] > 0
    assert all(stage.startswith("painter/") for stage in spade), spade
    assert res["attributed_ms"] == pytest.approx(res["total_ms"], rel=1e-2)
    for stage in ("masker/encoder", "masker/seg_decoder",
                  "masker/depth_decoder", "masker/mask_decoder"):
        assert res["stages_ms"].get(stage, 0) > 0, stage


def test_folded_forward_on_the_card_matches_the_unfolded():
    """fold_generator_bns on the tiny default generator in f32 (TF32 off),
    its batch norms with seeded statistics: depth, seg and mask within
    1e-5 of the unfolded forward."""
    import copy

    from climategan_torch.models.generator import create_generator
    from climategan_torch.models.norms import BatchNorm2d
    from climategan_torch.profile_inference import tiny_opts
    from climategan_torch.utils.bn_fold import fold_generator_bns

    dev = _device()
    G = create_generator(tiny_opts(64), 0).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        for m in G.modules():
            if isinstance(m, BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, device=dev, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, device=dev, generator=g) + 0.5)
                m.weight.copy_(torch.rand(c, device=dev, generator=g) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(c, device=dev, generator=g) * 0.1)
        x = torch.rand(2, 3, 64, 64, device=dev, generator=g) * 2 - 1
        want = G.infer_masker(x)
        got = fold_generator_bns(copy.deepcopy(G)).infer_masker(x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shards", [1, 2])
def test_layer_norm_on_the_card(shards):
    """The base mask decoder's layer norm (``norms.LayerNorm``) on the
    card, over the whole map or over ``shards`` row shards of the one card
    (``forward_rows``: float64 per-sample sums through
    ``spatial.all_reduce``): bf16 within one bf16 ulp of the same path's
    f32 on the same input (the statistics and the affine run in f32 either
    way); the f32 path within 1e-5 of the unsharded f32 forward, and so
    its input gradient."""
    from climategan_torch.models.norms import LayerNorm, init_weights
    from climategan_torch.parallel import spatial

    dev = _device()
    ln = LayerNorm(16)
    init_weights(ln, torch.Generator().manual_seed(0))
    ln = ln.to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(2, 16, 37, 29, device=dev, generator=g) * 3 + 1

    def run(t):
        if shards == 1:
            return ln(t)
        return ln.forward_rows(spatial.shard_rows(t, [dev] * shards)) \
            .gather(dev)

    x16 = x.bfloat16()
    with torch.no_grad():
        got, want = run(x16), run(x16.float())
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool(((got.float() - want).abs() <= ulp).all())
    xa, xb = (x.clone().requires_grad_(True) for _ in range(2))
    ya, yb = ln(xa), run(xb)
    torch.testing.assert_close(yb, ya, rtol=1e-5, atol=1e-5)
    r = torch.randn(ya.shape, device=dev, generator=g)
    (ya * r).sum().backward()
    (yb * r).sum().backward()
    torch.testing.assert_close(xb.grad, xa.grad, rtol=1e-5, atol=1e-5)


def test_adain_resize_like_and_unit_range_on_the_card():
    """``AdaptiveInstanceNorm`` (forward, its gradients, and ``forward_rows``
    over 2 shards of the card) and ``resize_like`` in each mode (a tensor
    and a 2-shard ``Rows``) on the card against the CPU in f32 within 1e-5;
    AdaIN's bf16 within one bf16 ulp of each value of its f32 path on the
    same input; ``uint8_to_unit_range`` on the card equal to the host's
    ``uint8_to_m11`` bit for bit."""
    from climategan_torch.models.norms import AdaptiveInstanceNorm
    from climategan_torch.ops.image import uint8_to_unit_range
    from climategan_torch.ops.interpolate import resize_like
    from climategan_torch.parallel import spatial
    from climategan_torch.utils.native import uint8_to_m11

    dev = _device()
    g = torch.Generator().manual_seed(17)
    x = torch.randn(2, 16, 37, 29, generator=g) * 3 + 1
    w = torch.rand(16, generator=g) + 0.5
    b = torch.randn(16, generator=g) * 0.5
    cot = torch.randn(x.shape, generator=g)
    norm = AdaptiveInstanceNorm()

    def run(device, shards=0):
        args = [t.to(device, copy=True).requires_grad_(True)
                for t in (x, w, b)]
        if shards:
            y = norm.forward_rows(spatial.shard_rows(args[0], [device] * 2),
                                  *args[1:]).gather(device)
        else:
            y = norm(*args)
        y.backward(cot.to(device))
        return [t.detach().cpu() for t in (y, *(a.grad for a in args))]

    want = run("cpu")
    for shards in (0, 2):
        for got, ref in zip(run(dev, shards), want):
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    x16, w16, b16 = (t.to(dev, torch.bfloat16) for t in (x, w, b))
    with torch.no_grad():
        got = norm(x16, w16, b16)
        ref = norm(x16.float(), w16.float(), b16.float())
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    assert bool(((got.float() - ref).abs() <= ulp).all())

    ref_map = torch.zeros(1, 3, 61, 47)
    for mode, ac in (("nearest", False), ("bilinear", False),
                     ("bilinear", True), ("bicubic", False)):
        want = resize_like(x, ref_map, mode, ac)
        got = resize_like(x.to(dev), ref_map.to(dev), mode, ac)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        rows = resize_like(spatial.shard_rows(x.to(dev), [dev] * 2),
                           ref_map.to(dev), mode, ac)
        torch.testing.assert_close(rows.gather("cpu"), want, rtol=1e-5,
                                   atol=1e-5)

    u8 = torch.randint(0, 256, (2, 3, 37, 29), generator=g, dtype=torch.uint8)
    got = uint8_to_unit_range(u8.to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got, uint8_to_m11(u8.numpy()))
