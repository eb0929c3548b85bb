"""Row sharding in one process (``climategan_torch/parallel/spatial.py``)
against the port's unsharded ops and forwards, on the CPU with shards on
``["cpu"] * k``; no JAX (tests/test_torch_port_events.py holds the
row-sharded ``infer`` to the JAX package's).

- the partition rule and the window fetch: halos wider than a shard, maps
  of fewer rows than shards, each edge padding;
- each sharded primitive against its unsharded self on the maps of the
  main path (2-82 rows): ``conv2d`` at every (kernel, stride, dilation,
  padding) of the default forward, ``max_pool2d``, each resize mode,
  instance norm, ``normalize``, the sky mask's blur and dilation;
- the sharded forwards of the encoder, the depth, seg and mask heads and
  the painter against ``forward`` at tiny sizes, and ``spade_cond`` on a
  window with a 2-row halo, cropped;
- the hybrid grid, one-shard calls (today's path), and each part's
  forward_rows in five other generator configurations (each configuration
  end to end: tests/test_torch_port_spatial_configs.py).

Bars: the JAX package's 1 uint8 LSB for the events (on >= 99.9% of
values) and 1e-5 for the mask; below that, float32, set from its rounding
before the runs: a product or sum
that the shards compute on other shapes within 1e-5 of values of order 1
(the same products in another order); the reductions, the blur and the
dilation within 1e-6; selections (nearest, max pool, windows) and float64
convs exact to 1e-12.
"""
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch import bench
from climategan_torch.inference import (
    build_hybrid_infer_fn,
    build_infer_fn,
    build_spatial_infer_fn,
)
from climategan_torch.kernels.spade_cond import spade_cond_plain
from climategan_torch.models.generator import create_generator
from climategan_torch.models.norms import instance_norm
from climategan_torch.ops.blur import gaussian_blur
from climategan_torch.ops.image import normalize
from climategan_torch.ops.interpolate import resize, upsample_nearest
from climategan_torch.parallel import spatial
from climategan_torch.parallel.mesh import (
    hybrid_groups,
    hybrid_size,
    spatial_size,
)
from tests.torch_port_common import one_thread, port_tiny_opts  # noqa: F401

CPUS = {k: ["cpu"] * k for k in (1, 2, 3, 4)}


def _rand(*shape, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    r = torch.rand(shape, generator=g, dtype=torch.float64)
    return (r * 2 - 1).to(dtype)


# ---- the partition rule and windows ---------------------------------------

def test_partition_rule_and_rows():
    assert spatial.split(5, 4) == [(0, 1), (1, 2), (2, 3), (3, 5)]
    assert spatial.split(2, 3) == [(0, 0), (0, 1), (1, 2)]
    assert spatial.split(82, 4) == [(0, 20), (20, 41), (41, 61), (61, 82)]
    x = _rand(2, 3, 2, 5)
    r = spatial.shard_rows(x, CPUS[4])
    assert [p.shape[2] for p in r.parts] == [0, 1, 0, 1]
    assert r.starts == [0, 0, 1, 1, 2] and r.h == 2
    assert torch.equal(r.gather("cpu"), x)
    nhwc = _rand(2, 7, 5, 3)
    r = spatial.shard_rows(nhwc, CPUS[3], dim=1)
    assert torch.equal(spatial.gather_rows(r, "cpu", nhwc=True), nhwc)
    assert all(p.is_contiguous() for p in r.parts)


def test_window_pads_only_at_the_image_edges():
    """Windows of every padding reaching rows before 0 and past h, wider
    than a neighbour's shard (2-row shards, an 18-row halo) and across
    0-row shards, against the whole map padded by F.pad (-inf: constant)."""
    for h, k in ((8, 4), (5, 4), (2, 3), (82, 3)):
        x = _rand(1, 2, h, 4, seed=h)
        r = spatial.shard_rows(x, CPUS[k])
        for mode, fmode in (("zero", "constant"), ("reflect", "reflect"),
                            ("replicate", "replicate"), ("-inf", "constant")):
            p = min(18, h - 1) if mode == "reflect" else 18
            kw = {"value": float("-inf")} if mode == "-inf" else {}
            full = F.pad(x, (0, 0, p, p), mode=fmode, **kw)
            for lo in range(-p, h + 1, max(1, h // 5)):
                for hi in (lo + 1, min(lo + 2 * p, h + p), h + p):
                    if hi <= lo:
                        continue
                    got = spatial.window(r, lo, hi, "cpu", mode)
                    assert torch.equal(got, full[:, :, lo + p:hi + p]), \
                        (h, k, mode, lo, hi)


# ---- convolutions and the max pool --------------------------------------

# (kernel, stride, dilation, padding) of the default forward at 640^2
CONVS = {
    "stem_7x7_s2": [(7, 2, 1, 3)],
    "3x3_dilations_1_2_4_8_16": [(3, 1, d, d) for d in (1, 2, 4, 8, 16)]
    + [(3, 2, 1, 1)],
    "aspp_6_12_18": [(3, 1, d, d) for d in (6, 12, 18)],
    "1x1_pad1_and_downsample_1x1_s2": [(1, 1, 1, 1), (1, 2, 1, 0),
                                       (1, 1, 1, 0)],
}


@pytest.mark.parametrize("name", list(CONVS))
def test_conv2d_matches_f_conv2d(name):
    """nn.Conv2d (float64, with bias) on maps of 2-82 rows over 2, 3 and 4
    shards."""
    for h in (2, 5, 13, 40, 82):
        x = _rand(2, 3, h, 6, seed=h)
        for ks, s, d, p in CONVS[name]:
            if spatial.out_rows(h, ks, s, p, d) < 1:
                continue
            torch.manual_seed(h)
            conv = nn.Conv2d(3, 4, ks, s, p, d).double()
            want = conv(x)
            for k in (2, 3, 4):
                got = spatial.conv2d(spatial.shard_rows(x, CPUS[k]), conv)
                assert [q.shape[2] for q in got.parts] == [
                    b - a for a, b in spatial.split(want.shape[2], k)]
                torch.testing.assert_close(got.gather("cpu"), want,
                                           rtol=0, atol=1e-12,
                                           msg=str((h, ks, s, d, p, k)))


def test_conv2d_blocks_pad_reflect_and_replicate_and_max_pool():
    """Conv2dBlock's padded SNConv (eval, baked kernel) with reflect,
    replicate and zero pads, and F.max_pool2d(3, 2, 1) with its -inf rows,
    against the unsharded modules."""
    from climategan_torch.models.blocks import Conv2dBlock
    from climategan_torch.models.norms import init_weights

    for pad_type in ("reflect", "replicate", "zero"):
        block = Conv2dBlock(3, 4, 3, 1, 1, norm="spectral", activation="lrelu",
                            pad_type=pad_type)
        init_weights(block, torch.Generator().manual_seed(1))
        block = block.double().eval()
        for h in (2, 5, 13, 82):
            x = _rand(1, 3, h, 6, seed=h)
            for k in (2, 3, 4):
                got = block.forward_rows(spatial.shard_rows(x, CPUS[k]))
                torch.testing.assert_close(got.gather("cpu"), block(x),
                                           rtol=0, atol=1e-12)
    for h in (2, 5, 13, 320):
        x = _rand(2, 3, h, 7, seed=h)
        for k in (2, 3, 4):
            got = spatial.max_pool2d(spatial.shard_rows(x, CPUS[k]), 3, 2, 1)
            assert torch.equal(got.gather("cpu"), F.max_pool2d(x, 3, 2, 1))


# ---- resizes -------------------------------------------------------------

# (input rows, output size) of each mode on the path: the SPADEs' and
# the fc's nearest conditioning (640 -> 5..640), DADA's bicubic 384 and
# nearest target, DeepLab's align_corners resizes (160 -> 82, 82 -> 160),
# the depth's bilinear to the image, the mask decoder's and paint_cloudy's
# align_corners=False resizes (160 -> 80, 160 -> 640)
RESIZES = {
    "nearest": [(640, (5, 7)), (640, (40, 7)), (384, (160, 9)),
                (16, (32, 5)), (160, (640, 6))],
    "bilinear_align_corners": [(160, (82, 82)), (82, (160, 160)),
                               (160, (640, 33))],
    "bilinear": [(160, (80, 80)), (160, (640, 24))],
    "bicubic": [(80, (384, 384)), (16, (384, 384))],
}


@pytest.mark.parametrize("mode", list(RESIZES))
def test_resize_rows_match_resize(mode):
    """The sharded resize (the rows' operator on the rows it reads, then
    the width) against ops/interpolate.resize on the whole map, float32:
    nearest exactly, the others within 1e-5."""
    ac = mode == "bilinear_align_corners"
    kind = "bilinear" if ac else mode
    for h, size in RESIZES[mode]:
        x = _rand(1, 2, h, 8, seed=h, dtype=torch.float32)
        want = resize(x, size, kind, align_corners=ac)
        for k in (2, 3, 4):
            got = spatial.resize(spatial.shard_rows(x, CPUS[k]), size, kind,
                                 align_corners=ac).gather("cpu")
            if kind == "nearest":
                assert torch.equal(got, want), (h, size, k)
            else:
                torch.testing.assert_close(got, want, rtol=0, atol=1e-5,
                                           msg=str((h, size, k)))
    if mode == "nearest":
        x = _rand(2, 3, 5, 5, dtype=torch.float32)
        for k in (2, 3, 4):
            got = spatial.upsample_nearest(spatial.shard_rows(x, CPUS[k]))
            assert torch.equal(got.gather("cpu"), upsample_nearest(x))


# ---- reductions over rows ------------------------------------------------

def test_instance_norm_and_normalize_match_unsharded():
    for h in (5, 20, 82):
        x = _rand(2, 4, h, 9, seed=h, dtype=torch.float32) * 3 + 1
        for k in (2, 3, 4):
            r = spatial.shard_rows(x, CPUS[k])
            torch.testing.assert_close(spatial.instance_norm(r).gather("cpu"),
                                       instance_norm(x), rtol=0, atol=1e-6)
            torch.testing.assert_close(
                spatial.normalize(r, 0.3, 1.0).gather("cpu"),
                normalize(x, 0.3, 1.0), rtol=0, atol=1e-6)


def test_sky_blur_and_dilation_rows_match_unsharded():
    """The wildfire's sky mask from row-sharded seg logits
    (``fire.sky_rows``: each shard's argmax gathered, the crop at the
    whole map's row 2h/3, the nearest resize and the box dilation on the
    whole mask) equals add_fire's, and each shard's rows of the 281-tap
    reflect blur, from the whole mask, equal the whole blur's rows."""
    from climategan_torch.events.fire import increase_sky_mask, sky_rows
    from climategan_torch.ops.image import retrieve_sky_mask

    seg = _rand(2, 11, 40, 40, seed=3, dtype=torch.float32)
    seg[:, 9, :20] += 2.0
    sky = retrieve_sky_mask(seg).float()
    sky[:, :, 2 * 40 // 3:] = 0.0
    want = increase_sky_mask(resize(sky, (96, 80), mode="nearest"), 0.18,
                             0.18)
    blur = gaussian_blur(want, 281, 140.5)
    assert 0 < want.mean() < 1
    for k in (2, 3, 4):
        got = sky_rows(spatial.shard_rows(seg, CPUS[k]), (96, 80))
        assert torch.equal(got, want)
        for lo, hi in spatial.split(96, k):
            torch.testing.assert_close(
                gaussian_blur(got, 281, 140.5, rows=(lo, hi)),
                blur[:, :, lo:hi], rtol=0, atol=1e-6)


# ---- the sharded forwards ------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The tiny model (f32, eval, seed 3) at 64^2, an input and the
    unsharded encoder's features."""
    opts = port_tiny_opts(64)
    G = create_generator(opts, seed=3).eval()
    x = _rand(2, 3, 64, 64, seed=4, dtype=torch.float32)
    with torch.no_grad():
        z = G.encoder(x)
    return opts, G, x, z


def _close(got, want, atol=1e-5):
    torch.testing.assert_close(got.gather("cpu"), want, rtol=0, atol=atol)


@pytest.mark.parametrize("part", ["encoder", "depth_and_seg", "mask",
                                  "painter"])
def test_forward_rows_match_forward(tiny, part):
    """Each part's forward_rows on 3 shards (uneven: the encoder's 8-row
    map splits 2/3/3) and 4 (2-row encoder shards under layer4's 16-row
    dilation; the painter's 2-row head leaves two shards empty) against
    its forward, the sharded part fed the unsharded part's inputs."""
    _, G, x, (zh, zl) = tiny
    with torch.no_grad():
        for k in (3, 4):
            def rows(t):
                return spatial.shard_rows(t, CPUS[k])

            if part == "encoder":
                gh, gl = G.encoder.forward_rows(rows(x))
                _close(gh, zh)
                _close(gl, zl)
            elif part == "depth_and_seg":
                d, zd = G.decoders["d"](zh)
                gd, gzd = G.decoders["d"].forward_rows(rows(zh))
                _close(gd, d)
                _close(gzd, zd)
                s = G.decoders["s"]((zh, zl), zd)
                _close(G.decoders["s"].forward_rows((rows(zh), rows(zl)),
                                                    rows(zd)), s)
            elif part == "mask":
                m = G.decoders["m"]((zh, zl))
                _close(G.decoders["m"].forward_rows((rows(zh), rows(zl))), m)
            else:
                cond = x * (x[:, :1] > 0)
                _close(G.painter.forward_rows(rows(cond)), G.painter(cond))


def test_spade_cond_on_a_halo_window_equals_the_whole_call():
    """spade_cond_plain on each shard's conditioning rows with a 2-row
    halo (clipped to the image), cropped to the shard's rows, equals the
    call on the whole map (its zero padding at the window's edge is the
    image's where the window ends there, and unread elsewhere); and the
    modules' path (norms.spade_windows, spade_cond_rows) on packs."""
    from climategan_torch.kernels.spade_cond import pack_spade_cond
    from climategan_torch.models.norms import spade_cond_rows, spade_windows

    g = torch.Generator().manual_seed(0)

    def w(*s):
        return torch.randn(s, generator=g) * 0.3

    k1, b1 = w(3, 3, 3, 16), w(16)
    branches = [(w(3, 3, 8, 5), w(5), w(3, 3, 8, 5), w(5))] * 2
    for h in (5, 13, 40):
        seg = w(2, h, 11, 3)
        want = spade_cond_plain(seg, k1, b1, branches)
        cond = spatial.shard_rows(seg.permute(0, 3, 1, 2), CPUS[4])
        wins = spade_windows(cond, cond)
        for dtype in (torch.float32, torch.bfloat16):
            pack = pack_spade_cond(*[t.to(dtype) for t in (k1, b1)],
                                   [tuple(t.to(dtype) for t in b)
                                    for b in branches])
            outs = spade_cond_rows(
                [None if v is None else (v[0].to(dtype), v[1], v[2])
                 for v in wins], lambda dev: pack)
            if dtype == torch.float32:
                got = [torch.cat([o[b] for o in outs if o is not None], 1)
                       for b in range(2)]
                for a, b in zip(got, want):
                    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        for k in (2, 3, 4):
            for lo, hi in spatial.split(h, k):
                if lo == hi:
                    continue
                wlo, whi = max(lo - 2, 0), min(hi + 2, h)
                outs = spade_cond_plain(seg[:, wlo:whi].contiguous(), k1, b1,
                                        branches)
                for got, full in zip(outs, want):
                    torch.testing.assert_close(
                        got[:, lo - wlo:hi - wlo], full[:, lo:hi], rtol=0,
                        atol=1e-6)


# ---- the inference builders ----------------------------------------------

def test_hybrid_grid_and_device_rules():
    """make_mesh_2d's order (each data group's shards adjacent), the JAX
    benches' rules, and a dp 2 x sp 2 forward on the CPU against the
    unsharded one."""
    devs = [torch.device("cuda", i) for i in range(8)]
    groups = hybrid_groups(devs, 2, 4)
    assert groups == [devs[:4], devs[4:]]
    assert hybrid_size(batch=6, rows=640, n=8, sp=2) == 3
    assert hybrid_size(batch=2, rows=640, n=4, sp=2) == 2
    with pytest.raises(ValueError, match="must divide"):
        hybrid_size(2, 640, 4, 3)
    assert spatial_size(640, 3) == 2 and spatial_size(640, 4) == 4
    args = bench.parse_args(["--hybrid", "2", "--batch", "2"])
    assert bench.layout(args, 4) == (2, 2) and bench.layout(args, 1) == (1, 1)
    assert bench.layout(bench.parse_args(["--spatial"]), 3) == (1, 2)
    opts = port_tiny_opts(64)
    x = _rand(4, 64, 64, 3, seed=5, dtype=torch.float32)
    u = torch.rand(9, 9, generator=torch.Generator().manual_seed(6))
    kw = dict(dtype=torch.float32, seed=3)
    want = build_infer_fn(opts, device="cpu", **kw)[1](x, uniform=u,
                                                       g_value=120.0)
    got = build_hybrid_infer_fn(opts, CPUS[4], 2, **kw)[1](
        x, uniform=u, g_value=120.0)
    for key in ("flood", "wildfire", "smog"):
        diff = (got[key].int() - want[key].int()).abs()
        print(f"hybrid {key}: max {diff.max().item()} LSB, "
              f"{100 * (diff == 0).float().mean().item():.3f}% equal")
        assert (diff <= 1).float().mean() >= 0.999, key
    torch.testing.assert_close(got["mask"], want["mask"], rtol=0, atol=1e-5)


def test_one_shard_is_the_plain_forward():
    """One device: build_spatial_infer_fn is build_infer_fn, bit for bit."""
    opts = port_tiny_opts(64)
    x = _rand(1, 64, 64, 3, seed=7, dtype=torch.float32)
    u = torch.rand(9, 9, generator=torch.Generator().manual_seed(8))
    kw = dict(dtype=torch.float32, seed=3)
    want = build_infer_fn(opts, device="cpu", **kw)[1](x, uniform=u,
                                                       g_value=111.0)
    got = build_spatial_infer_fn(opts, ["cpu"], **kw)[1](x, uniform=u,
                                                        g_value=111.0)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("override", [
    {"gen": {"m": {"use_spade": True}}},
    {"gen": {"deeplabv3": {"backbone": "mobilenet"}}},
    {"gen": {"encoder": {"architecture": "deeplabv2"}}},
    {"gen": {"d": {"classify": {"enable": True}}}},
    {"gen": {"p": {"no_z": False}}},
], ids=["spade_masker", "mobilenet", "deeplabv2", "depth_classification",
        "painter_with_z"])
def test_other_configurations_are_refused(override):
    """No configuration is refused row sharding: in each of these five
    (once refused, ROADMAP A.11b-3) every part's row-sharded forward over
    3 and 4 shards (the encoder's 8-row maps 2/3/3 and 2 a shard, the
    painter's 2-row head leaving shards empty) equals its forward, each
    fed the unsharded part's inputs: encode, depth, segmentation, the
    SPADE masker's conditioning, mask, depth_map and paint (with z, the
    same draw)."""
    opts = port_tiny_opts(64, **override)
    G = create_generator(opts, seed=3).eval()
    x = _rand(2, 3, 64, 64, seed=4, dtype=torch.float32)
    zp = G.sample_painter_z(2, 64, 64,
                            generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        z = G.encode(x)
        d, zd = G.depth(z)
        s = G.segmentation(z, zd)
        cond = G.make_m_cond(d, s, x) if G.cfg.m_use_spade else None
        m = G.mask(z, zd, cond=cond)
        mb = (m > 0.5).float()
        want = {"z": z, "d": d, "zd": zd, "s": s, "cond": cond, "m": m,
                "depth_map": G.depth_map(d), "paint": G.paint(mb, x, z=zp)}
        for k in (3, 4):
            def rows(t):
                if isinstance(t, (list, tuple)):
                    return tuple(rows(a) for a in t)
                return None if t is None else spatial.shard_rows(t, CPUS[k])

            gd, gzd = G.depth(rows(z))
            got = {"z": G.encode(rows(x)), "d": gd, "zd": gzd,
                   "s": G.segmentation(rows(z), rows(zd)),
                   "cond": (G.make_m_cond(rows(d), rows(s), rows(x))
                            if cond is not None else None),
                   "m": G.mask(rows(z), rows(zd), cond=rows(cond)),
                   "depth_map": G.depth_map(rows(d)),
                   "paint": G.paint(rows(mb), rows(x), z=zp)}
            for key, w in want.items():
                g = got[key]
                if w is None:
                    assert g is None, key
                    continue
                for a, b in (zip(g, w) if isinstance(w, tuple) else [(g, w)]):
                    _close(a, b)
