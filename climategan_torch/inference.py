"""Inference of the three events: x (NHWC, [-1, 1]) -> {"flood",
"wildfire", "smog": uint8 NHWC, "mask": NHWC}.

Masker (shared encoder, depth, segmentation, mask) -> binary mask ->
paint_cloudy (Perlin sky probe, SPADE painter) -> paste for the flood; the
wildfire and smog composite the same input with the seg logits and the
depth, in float32 on the model-dtype-rounded input; then per-image uint8
quantize.

``build_mesh_infer_fn`` serves the same forward split over in-process
replicas, one per device of a mesh (``--mesh``), as the JAX package's
batch-sharded forward: the draws are made once for the whole batch and the
wildfire's gray mean is the whole batch's. ``build_spatial_infer_fn``
splits each image's rows over devices (``--spatial``,
``parallel/spatial.py``) and ``build_hybrid_infer_fn`` does both, the
batch over data groups and each group's rows over its devices
(``--hybrid``), as the JAX package's row- and 2-D-sharded forwards.
"""
from __future__ import annotations

import sys
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from climategan_torch.events.fire import (
    add_fire,
    add_fire_rows,
    gray_sum,
    gray_sum_rows,
    warm_rows,
)
from climategan_torch.events.smog import add_smog, add_smog_rows
from climategan_torch.models.blocks import pack_spade_weights
from climategan_torch.models.generator import (
    CLOUDY_RES,
    GenConfig,
    OmniGenerator,
    create_generator,
)
from climategan_torch.ops.image import unit_range_to_uint8
from climategan_torch.parallel import spatial
from climategan_torch.parallel.mesh import (
    gather,
    hybrid_groups,
    mesh_size,
    spatial_size,
)
from climategan_torch.parallel.spatial import Rows


def resolve_device(device="cuda") -> torch.device:
    """The device to run on; a CUDA device that is absent raises, it never
    falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return device


def build_infer_fn(
    opts,
    dtype: torch.dtype = torch.bfloat16,
    bin_value: float = 0.5,
    cloudy: bool = True,
    ignore_event: Tuple[str, ...] = (),
    quantize: bool = True,
    device="cuda",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    seed: int = 0,
) -> Tuple[OmniGenerator, callable]:
    """Returns ``(G, infer)``;
    ``infer(x, uniform=None, generator=None, g_value=None, z=None)``.

    G is built in f32 with weights from ``state_dict`` (reference key
    layout, loaded strictly; spectral kernels baked from the loaded values)
    or, without one, random weights from ``seed``; it then moves to
    ``device`` in ``dtype``, and its SPADE weights are packed for the
    ``spade_cond`` kernel once. ``bin_value < 0`` keeps the smooth mask.
    ``uniform`` is the (9, 9) Perlin draw tensor (see ops/perlin.py);
    without it the draws come from ``generator``. ``g_value`` is the
    wildfire filter's green value (see events/fire.py); without it, it is
    drawn from ``generator``. ``z`` is the painter's NCHW latent where the
    painter takes one (``gen.p.no_z: false``); without it, it is drawn
    from ``generator`` or, without one, from the device's generator. The
    smog takes ``G.depth_map`` of the depth head: a classification head's
    bucket argmax, normalized. The events' knobs come from ``opts.events``.
    ``gray_mean``: the wildfire's batch gray mean where x is a part of a
    batch (``build_mesh_infer_fn``).
    """
    device = resolve_device(device)
    fire_kw, smog_kw = event_kwargs(opts)
    if state_dict is None:
        G = create_generator(opts, seed)
    else:
        G = OmniGenerator(GenConfig.from_opts(opts))
        G.load_state_dict(state_dict, strict=True)
    # eval() bakes the spectral kernels in f32 before the cast; the SPADE
    # packs are made once, on the device and in the model's dtype
    G = G.eval().to(device=device, dtype=dtype)
    pack_spade_weights(G)

    @torch.inference_mode()
    def infer(x, uniform: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              g_value=None, z: Optional[torch.Tensor] = None,
              gray_mean: Optional[torch.Tensor] = None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        # NCHW-contiguous, not the channels_last view of the NHWC input: on
        # an H100 (cuDNN of torch 2.11) a channels_last bf16 input sends one
        # dilated 3x3 512-channel conv of ResNet layer4 to a direct kernel
        # that took 94 of the masker's 106 ms at 640^2 batch 2 (PERF.md)
        x = x.to(device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous()
        d, s, m = G.infer_masker(x)
        out = {}
        if "flood" not in ignore_event:
            mb = (m > bin_value).to(x.dtype) if bin_value >= 0 else m
            if cloudy:
                flood = G.paint_cloudy(mb, x, s, uniform=uniform,
                                       generator=generator, z=z)
            else:
                flood = G.paint(mb, x, z=z, generator=generator)
            out["flood"] = flood.permute(0, 2, 3, 1)
        if "wildfire" not in ignore_event:
            out["wildfire"] = add_fire(
                x.float(), s.float(), g_value=g_value, generator=generator,
                gray_mean=gray_mean, **fire_kw).permute(0, 2, 3, 1)
        if "smog" not in ignore_event:
            out["smog"] = add_smog(
                x.float(), G.depth_map(d).float(), **smog_kw
            ).permute(0, 2, 3, 1)
        if quantize:
            out = {k: unit_range_to_uint8(v) for k, v in out.items()}
        out["mask"] = m.permute(0, 2, 3, 1)
        return out

    return G, infer


def event_kwargs(opts) -> Tuple[dict, dict]:
    """The keyword arguments of ``add_fire`` and ``add_smog`` from
    ``opts.events``."""
    fire = opts.events.get("fire", {}) or {}
    smog = opts.events.get("smog", {}) or {}
    return (dict(kernel_size=int(fire.get("kernel_size", 281)),
                 kernel_sigma=float(fire.get("kernel_sigma", 140.5)),
                 crop_bottom_sky_mask=bool(
                     fire.get("crop_bottom_sky_mask", True))),
            dict(airlight=float(smog.get("airlight", 0.76)),
                 beta=float(smog.get("beta", 2.0)),
                 vr=float(smog.get("vr", 1.0)),
                 yellow_color=tuple(smog.get("yellow_color", (224, 192, 29))),
                 alpha=float(smog.get("alpha", 20.0))))


def draws(G: OmniGenerator, shape, ignore, cloudy: bool, uniform, z,
          g_value, generator, first):
    """(uniform, z, g_value): the Perlin draws, the painter's z (None for
    a ``no_z`` painter) and the wildfire's green value of an NHWC batch of
    ``shape``, each made once for the whole batch in the single forward's
    order where it is not given, from ``generator`` (else the ``first``
    device's generator), as a forward split over devices needs them."""
    n, h, w = shape[0], shape[1], shape[2]
    where = first if generator is None else generator.device
    if "flood" not in ignore:
        if cloudy and uniform is None:
            uniform = torch.rand((CLOUDY_RES[0] + 1, CLOUDY_RES[1] + 1),
                                 generator=generator, device=where,
                                 dtype=torch.float32)
        if z is None:
            z = G.sample_painter_z(n, h, w, torch.float32, where, generator)
    if "wildfire" not in ignore and g_value is None:
        g_value = torch.randint(100, 151, (), generator=generator,
                                device=where)
    return uniform, z, g_value


def build_mesh_infer_fn(opts, devices: Sequence, **kwargs
                        ) -> Tuple[OmniGenerator, callable]:
    """``build_infer_fn`` with one replica of the model per device of
    ``devices`` (a device may repeat); returns ``(G of the first replica,
    infer)`` with ``infer``'s signature. A batch of n runs on the first
    ``mesh_size(n, len(devices))`` replicas, replica i on rows [i n / k,
    (i + 1) n / k); their outputs come back as one batch on the first
    device. As the single forward on the whole batch: the Perlin draws,
    the painter's z and the wildfire's green value are drawn once, in its
    order, from ``generator`` (else the first device's generator), and the
    wildfire's gray mean is the whole batch's, from every part's sums. A
    depth classification head's smog is refused on several devices."""
    devs = [resolve_device(d) for d in devices]
    replicas = [build_infer_fn(opts, device=d, **kwargs) for d in devs]
    G0 = replicas[0][0]
    if (len(devs) > 1 and G0.cfg.d_classify_buckets
            and "smog" not in kwargs.get("ignore_event", ())):
        raise ValueError("the smog of a depth classification head divides "
                         "by the batch's largest bucket (depth_map); a batch "
                         "split over replicas does not take it: serve it "
                         "without --mesh or with --ignore_event smog")
    dtype = kwargs.get("dtype", torch.bfloat16)
    ignore = tuple(kwargs.get("ignore_event", ()))
    cloudy = kwargs.get("cloudy", True)
    first = devs[0]

    @torch.inference_mode()
    def infer(x, uniform: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              g_value=None, z: Optional[torch.Tensor] = None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        n = x.shape[0]
        k = mesh_size(n, len(replicas))
        if k == 1:
            return replicas[0][1](x, uniform, generator, g_value, z)
        uniform, z, g_value = draws(G0, x.shape, ignore, cloudy, uniform, z,
                                    g_value, generator, first)
        per = n // k
        parts = [x[i * per:(i + 1) * per] for i in range(k)]
        gray_mean = None
        if "wildfire" not in ignore:
            # add_fire's input: the model-dtype-rounded NCHW image
            sums = [gray_sum(p.to(device=devs[i], dtype=dtype)
                             .permute(0, 3, 1, 2).float())
                    for i, p in enumerate(parts)]
            total = sum(s.to(first) for s, _ in sums)
            gray_mean = (total / sum(c for _, c in sums)).float()
        outs = [replicas[i][1](part, uniform, None, g_value,
                               None if z is None else z[i * per:(i + 1) * per],
                               gray_mean=None if gray_mean is None
                               else gray_mean.to(devs[i]))
                for i, part in enumerate(parts)]
        return gather(outs, first)

    return G0, infer


# ---- row sharding (--spatial) and data x rows (--hybrid) -------------------

def _indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card), as a
    tensor's ``.device`` names it."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _row_replicas(opts, devices: Sequence, kwargs):
    """(the devices with their index, G of the first, ``infer`` of the
    first, ``masker``, ``events``): one ``build_infer_fn`` replica per
    distinct device, linked for the sharded forward
    (``spatial.link_replicas``); ``masker(xr)`` is ``infer_masker`` on a
    row-sharded batch ``xr`` and ``events(xr, masked, uniform, g_value,
    gray_mean, z, largest)`` the rest of ``build_infer_fn``'s forward on
    its (d, s, m), with the draws given (``largest``: the batch's largest
    depth bucket where ``xr`` is a part of it), its outputs gathered as
    one NHWC batch on the first shard's device."""
    devs = [_indexed(d) for d in devices]
    built = {d: build_infer_fn(opts, device=d, **kwargs)
             for d in dict.fromkeys(devs)}
    G0, infer0 = built[devs[0]]
    spatial.link_replicas([G for G, _ in built.values()])
    dtype = kwargs.get("dtype", torch.bfloat16)
    bin_value = kwargs.get("bin_value", 0.5)
    cloudy = kwargs.get("cloudy", True)
    ignore = tuple(kwargs.get("ignore_event", ()))
    quantize = kwargs.get("quantize", True)
    fire_kw, smog_kw = event_kwargs(opts)

    def events(xr: Rows, masked, uniform, g_value, gray_mean=None, z=None,
               largest=None):
        d, s, m = masked
        out = {}
        if "flood" not in ignore:
            mb = (m.map(lambda p: (p > bin_value).to(dtype))
                  if bin_value >= 0 else m)
            out["flood"] = (G0.paint_cloudy_rows(mb, xr, s, uniform, z=z)
                            if cloudy else G0.paint_rows(mb, xr, z=z))
        if "wildfire" not in ignore:
            out["wildfire"] = add_fire_rows(
                xr.map(lambda p: p.float()), s.map(lambda p: p.float()),
                g_value, gray_mean=gray_mean, **fire_kw)
        if "smog" not in ignore:
            out["smog"] = add_smog_rows(
                xr.map(lambda p: p.float()),
                G0.depth_map(d, largest).map(lambda p: p.float()), **smog_kw)
        if quantize:
            # per image, with the whole image's min-max
            out = {k: spatial.normalize(v).map(
                lambda p: (p * 255.0).to(torch.uint8)) for k, v in out.items()}
        out["mask"] = m
        return {k: spatial.gather_rows(v, xr.devices[0], nhwc=True)
                for k, v in out.items()}

    return devs, G0, infer0, G0.infer_masker, events


def build_spatial_infer_fn(opts, devices: Sequence, divide_rows: bool = False,
                           **kwargs) -> Tuple[OmniGenerator, callable]:
    """``build_infer_fn`` with each image's rows split over ``devices`` (a
    device may repeat) in one process, for every generator configuration;
    returns ``(G of the first device, infer)`` with ``infer``'s signature.
    Every map of the forward is split by the partition rule of
    ``parallel/spatial.py`` and each shard runs on its device; every
    kernel launches once per shard with rows (``spade_cond`` on each
    SPADE's conditioning window), and the outputs come back as one batch
    on the first device. As the single forward: the draws (the painter's
    z too, where it takes one and none is given) are made once, in its
    order, from ``generator`` (else the first device's generator), and z
    is split by rows; every per-image reduction is the whole image's, and
    a depth classification head's largest bucket the whole batch's.
    ``divide_rows``: each batch runs on the first ``spatial_size(rows,
    len(devices))`` devices, the JAX CLI's rule (with a note on stderr
    where that leaves devices idle); else on all of them, evenly or not.
    One device is the plain forward. ``infer.unsharded`` is the first
    device's plain forward on the same model."""
    if len(devices) == 1:
        return build_infer_fn(opts, device=devices[0], **kwargs)
    devs, G0, infer0, masker, events = _row_replicas(opts, devices, kwargs)
    dtype = kwargs.get("dtype", torch.bfloat16)
    ignore = tuple(kwargs.get("ignore_event", ()))
    cloudy = kwargs.get("cloudy", True)
    noted = set()

    @torch.inference_mode()
    def infer(x, uniform: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              g_value=None, z: Optional[torch.Tensor] = None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        k = len(devs)
        if divide_rows:
            k = spatial_size(x.shape[1], len(devs))
            if k < len(devs) and k not in noted:
                noted.add(k)
                print(f"WARNING: {x.shape[1]} rows do not split evenly over "
                      f"{len(devs)} devices; using {k}", file=sys.stderr)
        if k == 1:
            return infer0(x, uniform, generator, g_value, z)
        uniform, z, g_value = draws(G0, x.shape, ignore, cloudy, uniform, z,
                                    g_value, generator, devs[0])
        xr = spatial.shard_rows(x, devs[:k], dtype, dim=1)
        return events(xr, masker(xr), uniform, g_value, z=z)

    infer.unsharded = infer0
    return G0, infer


def build_hybrid_infer_fn(opts, devices: Sequence, sp: int, **kwargs
                          ) -> Tuple[OmniGenerator, callable]:
    """Data x rows: ``devices`` (a device may repeat) as len // sp data
    groups of sp adjacent devices (``mesh.hybrid_groups``); a batch of n
    runs on the first ``mesh_size(n, groups)`` groups, group g on batch
    rows [g n / dp, (g + 1) n / dp), each image's rows split over the
    group's devices (``build_spatial_infer_fn``'s forward). The draws (the
    painter's z too) are made once for the whole batch, and the wildfire's
    gray mean and a depth classification head's largest bucket are the
    whole batch's, from every group's, as ``build_mesh_infer_fn`` does for
    the gray mean; the outputs come back as one batch on the first device.
    sp = 1 is ``build_mesh_infer_fn``."""
    if sp == 1:
        return build_mesh_infer_fn(opts, devices, **kwargs)
    groups = hybrid_groups(devices, len(devices) // sp, sp)
    devs, G0, infer0, masker, events = _row_replicas(
        opts, [d for g in groups for d in g], kwargs)
    groups = hybrid_groups(devs, len(groups), sp)
    dtype = kwargs.get("dtype", torch.bfloat16)
    ignore = tuple(kwargs.get("ignore_event", ()))
    cloudy = kwargs.get("cloudy", True)
    first = devs[0]

    @torch.inference_mode()
    def infer(x, uniform: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              g_value=None, z: Optional[torch.Tensor] = None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        n = x.shape[0]
        dp = mesh_size(n, len(groups))
        uniform, z, g_value = draws(G0, x.shape, ignore, cloudy, uniform, z,
                                    g_value, generator, first)
        per = n // dp
        xrs = [spatial.shard_rows(x[g * per:(g + 1) * per], groups[g], dtype,
                                  dim=1) for g in range(dp)]
        gray_mean = None
        if "wildfire" not in ignore and dp > 1:
            sums = [gray_sum_rows(warm_rows(xr.map(lambda p: p.float())))
                    for xr in xrs]
            total = sum(s.to(first) for s, _ in sums)
            gray_mean = (total / sum(c for _, c in sums)).float()
        masked = [masker(xr) for xr in xrs]
        largest = None
        if "smog" not in ignore and G0.cfg.d_classify_buckets and dp > 1:
            largest = torch.stack([G0.bucket_max(G0.bucket_index(d))
                                   .to(first) for d, _, _ in masked]).amax()
        outs = [events(xr, masked[g], uniform, g_value,
                       None if gray_mean is None
                       else gray_mean.to(groups[g][0]),
                       None if z is None else z[g * per:(g + 1) * per],
                       largest)
                for g, xr in enumerate(xrs)]
        return gather(outs, first)

    return G0, infer
