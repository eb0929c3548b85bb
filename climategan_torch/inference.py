"""Inference of the three events: x (NHWC, [-1, 1]) -> {"flood",
"wildfire", "smog": uint8 NHWC, "mask": NHWC}.

Masker (shared encoder, depth, segmentation, mask) -> binary mask ->
paint_cloudy (Perlin sky probe, SPADE painter) -> paste for the flood; the
wildfire and smog composite the same input with the seg logits and the
depth, in float32 on the model-dtype-rounded input; then per-image uint8
quantize.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from climategan_torch.events.fire import add_fire
from climategan_torch.events.smog import add_smog
from climategan_torch.models.blocks import pack_spade_weights
from climategan_torch.models.generator import (
    GenConfig,
    OmniGenerator,
    create_generator,
)
from climategan_torch.ops.image import unit_range_to_uint8


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
    """
    device = resolve_device(device)
    fire_opts = opts.events.get("fire", {}) or {}
    smog_opts = opts.events.get("smog", {}) or {}
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
              g_value=None, z: Optional[torch.Tensor] = None):
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
                kernel_size=int(fire_opts.get("kernel_size", 281)),
                kernel_sigma=float(fire_opts.get("kernel_sigma", 140.5)),
                crop_bottom_sky_mask=bool(
                    fire_opts.get("crop_bottom_sky_mask", True)),
            ).permute(0, 2, 3, 1)
        if "smog" not in ignore_event:
            out["smog"] = add_smog(
                x.float(), G.depth_map(d).float(),
                airlight=float(smog_opts.get("airlight", 0.76)),
                beta=float(smog_opts.get("beta", 2.0)),
                vr=float(smog_opts.get("vr", 1.0)),
                yellow_color=tuple(smog_opts.get("yellow_color",
                                                 (224, 192, 29))),
                alpha=float(smog_opts.get("alpha", 20.0)),
            ).permute(0, 2, 3, 1)
        if quantize:
            out = {k: unit_range_to_uint8(v) for k, v in out.items()}
        out["mask"] = m.permute(0, 2, 3, 1)
        return out

    return G, infer
