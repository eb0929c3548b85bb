"""Flood inference: x (NHWC, [-1, 1]) -> {"flood": uint8 NHWC, "mask": NHWC}.

Masker (shared encoder, depth, segmentation, mask) -> binary mask ->
paint_cloudy (Perlin sky probe, SPADE painter) -> paste -> per-image uint8
quantize. Wildfire and smog are not ported yet.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

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
    ignore_event: Tuple[str, ...] = ("wildfire", "smog"),
    quantize: bool = True,
    device="cuda",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    seed: int = 0,
) -> Tuple[OmniGenerator, callable]:
    """Returns ``(G, infer)``; ``infer(x, uniform=None, generator=None)``.

    G is built in f32 with weights from ``state_dict`` (reference key
    layout, loaded strictly; spectral kernels baked from the loaded values)
    or, without one, random weights from ``seed``; it then moves to
    ``device`` in ``dtype``. ``bin_value < 0`` keeps the smooth mask.
    ``uniform`` is the (9, 9) Perlin draw tensor (see ops/perlin.py);
    without it the draws come from ``generator``.
    """
    missing = {"wildfire", "smog"} - set(ignore_event)
    if missing:
        raise NotImplementedError(
            f"events {sorted(missing)} are not ported yet (slice 2 of the "
            f"port); pass ignore_event=('wildfire', 'smog')")
    device = resolve_device(device)
    if state_dict is None:
        G = create_generator(opts, seed)
    else:
        G = OmniGenerator(GenConfig.from_opts(opts))
        G.load_state_dict(state_dict, strict=True)
    G = G.to(device=device, dtype=dtype).eval()

    @torch.inference_mode()
    def infer(x, uniform: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        # NCHW-contiguous, not the channels_last view of the NHWC input: on
        # an H100 (cuDNN of torch 2.11) a channels_last bf16 input sends one
        # dilated 3x3 512-channel conv of ResNet layer4 to a direct kernel
        # that took 94 of the masker's 106 ms at 640^2 batch 2 (PERF.md)
        x = x.to(device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous()
        _, s, m = G.infer_masker(x)
        out = {}
        if "flood" not in ignore_event:
            mb = (m > bin_value).to(x.dtype) if bin_value >= 0 else m
            if cloudy:
                flood = G.paint_cloudy(mb, x, s, uniform=uniform,
                                       generator=generator)
            else:
                flood = G.paint(mb, x)
            out["flood"] = flood.permute(0, 2, 3, 1)
        if quantize:
            out = {k: unit_range_to_uint8(v) for k, v in out.items()}
        out["mask"] = m.permute(0, 2, 3, 1)
        return out

    return G, infer
