"""Row sharding in one process: the space axis of the JAX package's
``parallel/mesh.py`` (``spatial_sharding``, ``shard_spatial``), where XLA
splits the H axis of every NHWC array over a mesh and inserts the halo
exchanges and collectives itself.

Here a map (N, C, H, W) is a ``Rows``: a list of k tensors, shard i on its
own device with rows ``[i h // k, (i + 1) h // k)`` of the map's h rows
(``split``; uneven where h is, a shard may hold 0 rows). Each sharded op
computes shard i's rows of its output under the same rule: it takes the
input rows they read, which follow from the op's kernel, stride, dilation
and padding (``window``), from whichever shards hold them, and pads only
where the window crosses the image's top or bottom (zero, reflect,
replicate, or -inf for a max pool). A halo is a slice and a copy between
devices (none on one device), so a halo wider than the neighbour's shard,
or a map of fewer rows than shards, needs no special case.

Reductions over rows (instance norm, per-sample min-max) sum or take the
min or max of the shards' partials on the first shard's device and copy
the result back (``all_reduce``). Resizes take rows ``[lo, hi)`` of the
(h_out, h_in) interpolation operator along the rows, built on the host
with PyTorch's own rules and cached, on the source rows they read; the
width axis is ``ops/interpolate.resize``.

In eval mode modules run on each shard's device through ``local(module,
device)``: the replicas of one model on several devices are linked once
(``link_replicas``) and each submodule finds its twin on a shard's device.
In train mode there is one set of parameters: every shard reads the
module's own parameters through ``.to(device)`` (no copy on their own
device), so autograd sums each shard's gradient into them, and a spectral
conv runs its power iteration once per call (``conv_weights``) for every
shard. The halos, resizes and reductions are slices, copies, products and
stacks, all differentiable, so the backward of a sharded forward is the
backward of the whole map. Exchanges and collectives run inside
``torch.profiler.record_function`` ranges ("spatial.exchange",
"spatial.collective") while a profiler is on, so a trace tells their share.

A convolution on a shard's window runs inside ``whole_map``, so that a
rematerialization policy that decides by a conv input's area
(``train_step.make_remat_policy``) reads the whole map's, and a sharded
step saves the convolutions the unsharded step saves.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.ops.interpolate import resize as resize2d

_PAD_MODES = ("zero", "reflect", "replicate", "-inf")


def split(h: int, k: int) -> List[Tuple[int, int]]:
    """The partition rule: shard i of k holds rows [i h // k, (i + 1) h //
    k) of a map of h rows."""
    return [(i * h // k, (i + 1) * h // k) for i in range(k)]


_WHOLE = threading.local()


@contextlib.contextmanager
def whole_map(h: int, w: int):
    """Inside the block ``whole_area()`` is ``h * w``: the area of the
    input that the op on the whole map would read (a padded map where the
    pad precedes the op), where it reads a shard's window. Per thread:
    autograd may recompute a rematerialized forward on another thread,
    which sets its own."""
    prev = getattr(_WHOLE, "area", None)
    _WHOLE.area = h * w
    try:
        yield
    finally:
        _WHOLE.area = prev


def whole_area() -> Optional[int]:
    """The whole map's area inside ``whole_map``, else None."""
    return getattr(_WHOLE, "area", None)


def trace_range(name: str):
    """A profiler range while a profiler is on, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Rows:
    """A (N, C, H, W) map whose rows are split over shards: ``parts[i]``
    holds rows ``[starts[i], starts[i + 1])`` on its own device."""

    __slots__ = ("parts", "starts")

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = list(parts)
        starts = [0]
        for p in self.parts:
            starts.append(starts[-1] + p.shape[-2])
        self.starts = starts

    @property
    def h(self) -> int:
        return self.starts[-1]

    @property
    def k(self) -> int:
        return len(self.parts)

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    @property
    def w(self) -> int:
        return self.parts[0].shape[3]

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of the first shard with rows (an empty shard made
        outside an autocast op may keep the input's)."""
        for p in self.parts:
            if p.shape[-2]:
                return p.dtype
        return self.parts[0].dtype

    def bounds(self, i: int) -> Tuple[int, int]:
        return self.starts[i], self.starts[i + 1]

    def like(self, rows: int, device, channels: Optional[int] = None,
             width: Optional[int] = None, dtype=None) -> torch.Tensor:
        """An empty (N, C, rows, W) tensor of this map's N, C, W and dtype
        (or those given) on ``device``."""
        n, c, _, w = self.parts[0].shape
        return torch.empty((n, c if channels is None else channels, rows,
                            w if width is None else width),
                           dtype=dtype or self.dtype, device=device)

    def fetch(self, lo: int, hi: int, device) -> torch.Tensor:
        """Rows [lo, hi) of the map (0 <= lo <= hi <= h) on ``device``: a
        view of one shard's rows where they lie on one shard of that
        device, else the pieces copied and joined."""
        pieces = []
        for i, p in enumerate(self.parts):
            a, b = max(lo, self.starts[i]), min(hi, self.starts[i + 1])
            if a < b:
                s = self.starts[i]
                pieces.append(p[:, :, a - s:b - s])
        if not pieces:
            return self.like(0, device)
        if len(pieces) == 1 and pieces[0].device == torch.device(device):
            return pieces[0]
        with trace_range("spatial.exchange"):
            pieces = [q.to(device) for q in pieces]
            return pieces[0] if len(pieces) == 1 else torch.cat(pieces, 2)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Rows":
        """``fn`` on every shard (an op of each row's own values)."""
        return Rows([fn(p) for p in self.parts])

    def zip(self, other: "Rows", fn) -> "Rows":
        """``fn(a, b)`` on the shards of two maps split alike."""
        if self.starts != other.starts:
            raise ValueError(f"maps split as {self.starts} and "
                             f"{other.starts}")
        return Rows([fn(a, b) for a, b in zip(self.parts, other.parts)])

    def cat(self, *others: "Rows") -> "Rows":
        """The channels of maps split alike, joined shard by shard."""
        for o in others:
            if o.starts != self.starts:
                raise ValueError(f"maps split as {self.starts} and "
                                 f"{o.starts}")
        return Rows([torch.cat(ps, 1) for ps in
                     zip(self.parts, *(o.parts for o in others))])

    def gather(self, device) -> torch.Tensor:
        """The whole map on ``device``."""
        return self.fetch(0, self.h, device)


def each(fn: Callable, *args):
    """``fn`` shard by shard where any argument is a ``Rows`` (the others
    passed to every call as they are; the maps split alike), else ``fn``
    of the arguments: an op of each row's own values on a map that may be
    sharded."""
    maps = [a for a in args if isinstance(a, Rows)]
    if not maps:
        return fn(*args)
    for m in maps[1:]:
        if m.starts != maps[0].starts:
            raise ValueError(f"maps split as {maps[0].starts} and "
                             f"{m.starts}")
    return Rows([fn(*(a.parts[i] if isinstance(a, Rows) else a
                      for a in args)) for i in range(maps[0].k)])


def is_rows(z) -> bool:
    """Whether ``z`` is a ``Rows`` or a tuple or list of them."""
    return isinstance(z, Rows) or (isinstance(z, (list, tuple)) and bool(z)
                                   and isinstance(z[0], Rows))


# ---- batches in and out ----------------------------------------------------

def shard_rows(x: torch.Tensor, devices: Sequence, dtype=None,
               dim: int = 2) -> Rows:
    """Shard the rows (axis ``dim``) of ``x`` over ``devices`` by the
    partition rule, each shard moved to its device (and cast to ``dtype``)
    and made an NCHW-contiguous part; an NHWC batch (``dim=1``) is
    permuted to NCHW."""
    h = x.shape[dim]
    parts = []
    for (lo, hi), d in zip(split(h, len(devices)), devices):
        p = x.narrow(dim, lo, hi - lo).to(device=d, dtype=dtype or x.dtype)
        if dim == 1:
            p = p.permute(0, 3, 1, 2)
        parts.append(p.contiguous())
    return Rows(parts)


def split_rows(t: torch.Tensor, devices: Sequence) -> Rows:
    """The rows (axis -2) of ``t``, an (N, C, H, W) map or (N, H, W)
    labels, split over ``devices`` by the partition rule, each shard a copy
    on its device (a view where it is already there)."""
    h = t.shape[-2]
    return Rows([t.narrow(t.ndim - 2, lo, hi - lo).to(d)
                 for (lo, hi), d in zip(split(h, len(devices)), devices)])


def gather_rows(r: Rows, device, nhwc: bool = False) -> torch.Tensor:
    """The whole map on ``device`` (NHWC where asked)."""
    y = r.gather(device)
    return y.permute(0, 2, 3, 1) if nhwc else y


# ---- collectives ---------------------------------------------------------

def all_reduce(values: Sequence[Optional[torch.Tensor]], op: str,
               devices: Sequence) -> List[torch.Tensor]:
    """The sum, min or max of the shards' partials (None for a shard with
    nothing to give), taken on the first device, copied to each shard's
    device; copies and a stack, so with a gradient to every partial (a
    min or max's to the partial that holds it)."""
    with trace_range("spatial.collective"):
        first = torch.device(devices[0])
        got = [v.to(first) for v in values if v is not None]
        stacked = torch.stack(got)
        total = {"sum": lambda t: t.sum(0), "min": lambda t: t.amin(0),
                 "max": lambda t: t.amax(0)}[op](stacked)
        return [total.to(d) for d in devices]


# ---- replicas ------------------------------------------------------------

def link_replicas(models: Sequence[nn.Module]) -> None:
    """Link the replicas of one model, one per device, so that each
    submodule finds its twin on another device (``local``). The replicas
    must have the same structure."""
    named = [dict(m.named_modules()) for m in models]
    for name in named[0]:
        twins = {}
        for mods in named:
            mod = mods[name]
            p = next(mod.parameters(), None)
            if p is None:
                p = next(mod.buffers(), None)
            if p is not None:
                twins[p.device] = mod
        for mods in named:
            object.__setattr__(mods[name], "_row_replicas", twins)


def local(module: nn.Module, device) -> nn.Module:
    """``module``'s replica on ``device`` (``link_replicas``); an unlinked
    module is itself (it must lie on that device)."""
    twins = getattr(module, "_row_replicas", None)
    if not twins:
        return module
    try:
        return twins[torch.device(device)]
    except KeyError:
        raise ValueError(f"no replica of {type(module).__name__} on "
                         f"{device}") from None


def apply(r: Rows, module: nn.Module) -> Rows:
    """A module that acts on each row alone (an eval batch norm, an
    activation) on every shard, through its replica on the shard's device
    (eval mode)."""
    return Rows([local(module, p.device)(p) if p.shape[2] else p
                 for p in r.parts])


# ---- windows and convolutions ------------------------------------------

def window(r: Rows, lo: int, hi: int, device, mode: str = "zero"
           ) -> torch.Tensor:
    """Rows [lo, hi) of the map on ``device``; rows outside [0, h) are
    padded as the image's edge asks: "zero", "reflect" (no edge repeat,
    as ``F.pad``), "replicate" or "-inf"."""
    h = r.h
    mid = r.fetch(min(max(lo, 0), h), max(min(hi, h), 0), device)
    n_top = max(0, min(hi, 0) - lo)
    n_bot = max(0, hi - max(lo, h))
    if not n_top and not n_bot:
        return mid
    if mode not in _PAD_MODES:
        raise ValueError(f"unknown padding {mode!r}")

    def pad(n, top):
        if mode in ("zero", "-inf"):
            t = r.like(n, device)
            return t.fill_(0.0 if mode == "zero" else float("-inf"))
        if mode == "replicate":
            edge = r.fetch(0, 1, device) if top else r.fetch(h - 1, h, device)
            return edge.expand(-1, -1, n, -1)
        # reflect: row -j is row j, row h - 1 + j is row h - 1 - j
        if top:
            a, b = 1 - min(hi, 0), 1 - lo
        else:
            a, b = 2 * h - 1 - hi, 2 * h - 1 - max(lo, h)
        if a < 0 or b > h:
            raise ValueError(f"a reflect pad of {n} rows on a map of {h}")
        return r.fetch(a, b, device).flip(2)

    with trace_range("spatial.exchange"):
        pieces = ([pad(n_top, True)] if n_top else []) + [mid] + (
            [pad(n_bot, False)] if n_bot else [])
        return torch.cat(pieces, 2)


def out_rows(h: int, k: int, stride: int, pad: int, dilation: int) -> int:
    """The rows of a window op's output on a map of h rows."""
    return (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def conv_spec(conv: nn.Module) -> Tuple[int, int, int]:
    """(stride, padding, dilation) of an ``nn.Conv2d`` or ``SNConv`` with
    square ones."""
    s, p, d = conv.stride, conv.padding, conv.dilation
    s, p, d = (v if isinstance(v, int) else v[0] for v in (s, p, d))
    if any(isinstance(v, tuple) and len(set(v)) > 1
           for v in (conv.stride, conv.padding, conv.dilation)):
        raise ValueError("row sharding takes square strides, pads and "
                         "dilations")
    return s, p, d


def conv_weights(conv: nn.Module, update_sn: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            Optional[torch.Tensor]]:
    """(weight, bias, scale) that a forward of ``conv`` reads: an
    ``nn.Conv2d``'s weight and bias, or an eval ``SNConv``'s baked kernel
    and its bias, with no scale; a train-mode spectral ``SNConv``'s
    ``weight_bar``, bias and ``1 / sigma`` from one power iteration
    (``SNConv.train_weights``, which stores u/v under ``update_sn``)."""
    if isinstance(conv, nn.Conv2d):
        return conv.weight, conv.bias, None
    if conv.training and conv.spectral:
        return conv.train_weights(update_sn)
    bias = conv.module.bias if conv.spectral else conv.bias
    return conv.weight, bias, None


def _out_dtype(dtype: torch.dtype, device: torch.device) -> torch.dtype:
    """The dtype a conv gives an input of ``dtype``: autocast's where it
    is on."""
    if torch.is_autocast_enabled(device.type):
        return torch.get_autocast_dtype(device.type)
    return dtype


def conv2d(r: Rows, conv: nn.Module, pad: int = 0,
           mode: str = "zero", update_sn: bool = False) -> Rows:
    """``conv`` (an ``nn.Conv2d``, grouped or not, or an ``SNConv``) on the
    sharded map. ``pad``/``mode``: a pad of the input before the conv on all four
    sides (``Conv2dBlock``'s), with the conv's own padding 0; else the
    conv's zero padding. In eval mode each shard runs the conv's replica
    on its device; in train mode the conv's own weights, read once for
    all shards (one power iteration, u/v stored under ``update_sn``), as
    the unsharded train forward computes: the spectral scale after the
    conv, then the bias."""
    s, p, d = conv_spec(conv)
    if pad:
        if p:
            raise ValueError("a padded input and a padding conv")
        p = pad
    kh = conv.weight.shape[2]
    h_out = out_rows(r.h, kh, s, p, d)
    kw = conv.weight.shape[3]
    w_out = out_rows(r.parts[0].shape[3], kw, s, p, d)
    train = conv.training
    # the input of the unsharded conv: the map, padded first where a pad
    # precedes the conv
    whole = (r.h + 2 * pad, r.w + 2 * pad) if pad else (r.h, r.w)
    # train mode: the weights of one power iteration, for every shard
    w0, b0, scale = (conv_weights(conv, update_sn) if train
                     else (None, None, None))
    parts = []
    for (a, b), dev in zip(split(h_out, r.k), r.devices):
        if not train:
            # a replica on the shard's device, or a module's own weights
            # read there (a frozen module without replicas, as the VGG)
            w0, b0, _ = conv_weights(local(conv, dev))
        w, bias = w0.to(dev), None if b0 is None else b0.to(dev)
        if a == b:
            parts.append(r.like(0, dev, w.shape[0], w_out,
                                _out_dtype(r.dtype, torch.device(dev))))
            continue
        win = window(r, a * s - p, (b - 1) * s - p + d * (kh - 1) + 1, dev,
                     mode)
        if mode != "zero":
            win = F.pad(win, (p, p, 0, 0), mode=mode)
        with whole_map(*whole):
            y = F.conv2d(win, w, bias if scale is None else None, s,
                         (0, p) if mode == "zero" else 0, d,
                         getattr(conv, "groups", 1))
        if scale is not None:
            y = y * scale.to(dev).to(y.dtype)
            if bias is not None:
                y = y + bias.to(y.dtype)[:, None, None]
        parts.append(y)
    return Rows(parts)


def pool_rows(h: int, kernel: int, stride: int, padding: int,
              ceil_mode: bool = False) -> int:
    """The rows of a max pool's output on a map of h rows, by PyTorch's
    rule: with ``ceil_mode`` a last window that starts inside the image
    (or its top padding) counts even where it runs past the bottom."""
    if not ceil_mode:
        return out_rows(h, kernel, stride, padding, 1)
    n = -(-(h + 2 * padding - kernel) // stride) + 1
    return n - 1 if (n - 1) * stride >= h + padding else n


def max_pool2d(r: Rows, kernel: int, stride: int, padding: int,
               ceil_mode: bool = False) -> Rows:
    """``F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)``;
    rows beyond the image are -inf, as the pool's own padding and a ceil
    window's overhang."""
    h_out = pool_rows(r.h, kernel, stride, padding, ceil_mode)
    w_out = pool_rows(r.w, kernel, stride, padding, ceil_mode)
    parts = []
    for (a, b), dev in zip(split(h_out, r.k), r.devices):
        if a == b:
            parts.append(r.like(0, dev, width=w_out))
            continue
        win = window(r, a * stride - padding,
                     (b - 1) * stride - padding + kernel, dev, "-inf")
        parts.append(F.max_pool2d(win, kernel, stride, (0, padding),
                                  ceil_mode=ceil_mode))
    return Rows(parts)


def avg_pool2d(r: Rows, kernel: int, stride: int, padding: int) -> Rows:
    """``F.avg_pool2d(x, kernel, stride, padding, count_include_pad=
    False)``: each window's sum over the count of its pixels inside the
    image, which differs from kernel^2 only at the image's edges, never at
    a shard's. The window is made NCHW-contiguous first
    (``discriminator.avg_pool_3x3_s2`` says why)."""
    h_out = out_rows(r.h, kernel, stride, padding, 1)
    w_out = out_rows(r.w, kernel, stride, padding, 1)
    parts = []
    for (a, b), dev in zip(split(h_out, r.k), r.devices):
        if a == b:
            parts.append(r.like(0, dev, width=w_out))
            continue
        lo, hi = a * stride - padding, (b - 1) * stride - padding + kernel
        win = window(r, lo, hi, dev, "zero").contiguous()
        inside = torch.zeros((1, 1, hi - lo, r.w), dtype=win.dtype,
                             device=dev)
        inside[:, :, max(0, -lo):min(hi, r.h) - lo] = 1.0
        sums, counts = (F.avg_pool2d(t, kernel, stride, (0, padding),
                                     divisor_override=1)
                        for t in (win, inside))
        parts.append(sums / counts)
    return Rows(parts)


# ---- resizes -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def row_operator(h_in: int, h_out: int, mode: str, align_corners: bool,
                 dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The (h_out, h_in) operator of ``F.interpolate`` along the rows: the
    interpolation of the identity in ``dtype``, so each output row's
    weights (computed in float32 for the f32 and bf16 maps it serves, in
    float64 for float64 ones) and the source rows it reads (clamped at the
    borders) are PyTorch's own; kept in float64."""
    eye = torch.eye(h_in, dtype=dtype).reshape(1, h_in, h_in, 1)
    if mode == "nearest":
        y = F.interpolate(eye, size=(h_out, 1), mode="nearest")
    else:
        y = F.interpolate(eye, size=(h_out, 1), mode=mode,
                          align_corners=align_corners)
    return y[0, :, :, 0].t().double().numpy()


@functools.lru_cache(maxsize=None)
def nearest_rows(h_in: int, h_out: int) -> np.ndarray:
    """The source row of each output row of a nearest resize, as
    ``F.interpolate`` takes it (float32 index arithmetic)."""
    src = torch.arange(h_in, dtype=torch.float32).reshape(1, 1, h_in, 1)
    y = F.interpolate(src, size=(h_out, 1), mode="nearest")
    return y.reshape(-1).to(torch.int64).numpy()


@functools.lru_cache(maxsize=None)
def _operator_rows(h_in: int, h_out: int, mode: str, align_corners: bool,
                   lo: int, hi: int, device: torch.device,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, int, int]:
    """Rows [lo, hi) of the operator, cut to the source rows [c0, c1) they
    read, in ``dtype`` (float32 or float64) on ``device``; with (c0,
    c1)."""
    m = row_operator(h_in, h_out, mode, align_corners, dtype)[lo:hi]
    cols = np.nonzero(np.any(m != 0.0, axis=0))[0]
    c0, c1 = int(cols[0]), int(cols[-1]) + 1
    # a normal tensor even when first made in an inference-mode forward: a
    # later training forward saves it for its backward
    with torch.inference_mode(False):
        return (torch.from_numpy(np.ascontiguousarray(m[:, c0:c1]))
                .to(dtype).to(device), c0, c1)


@functools.lru_cache(maxsize=None)
def _nearest_index(h_in: int, h_out: int, lo: int, hi: int,
                   device: torch.device) -> Tuple[torch.Tensor, int, int]:
    src = nearest_rows(h_in, h_out)[lo:hi]
    c0, c1 = int(src.min()), int(src.max()) + 1
    with torch.inference_mode(False):  # as _operator_rows
        return torch.from_numpy(src - c0).to(device), c0, c1


class Resized:
    """A map resized to ``size`` = (h_out, w_out) by ``ops/interpolate.
    resize``'s rules, whose rows are computed where they are fetched: rows
    [lo, hi) read only the source rows their interpolation weights reach.
    ``src`` is a ``Rows`` or another ``Resized`` (a chain of resizes)."""

    def __init__(self, src, size, mode: str, align_corners: bool = False):
        self.src = src
        self.h, self.w = int(size[0]), int(size[1])
        self.mode, self.align_corners = mode, bool(align_corners)

    @property
    def dtype(self) -> torch.dtype:
        return self.src.dtype

    def fetch(self, lo: int, hi: int, device) -> torch.Tensor:
        src, device = self.src, torch.device(device)
        if hi <= lo:
            t = src.fetch(0, 0, device)
            return t.new_empty((t.shape[0], t.shape[1], 0, self.w))
        if src.h == self.h:
            rows = src.fetch(lo, hi, device)
        elif self.mode == "nearest":
            idx, c0, c1 = _nearest_index(src.h, self.h, lo, hi, device)
            rows = src.fetch(c0, c1, device).index_select(2, idx)
        else:
            # in f32 (float64 for float64) through both axes, one cast at
            # the end, as resize
            st = torch.promote_types(src.dtype, torch.float32)
            m, c0, c1 = _operator_rows(src.h, self.h, self.mode,
                                       self.align_corners, lo, hi, device, st)
            win = src.fetch(c0, c1, device)
            y = torch.matmul(m, win.to(st))
            if y.shape[3] != self.w:
                y = F.interpolate(y, size=(hi - lo, self.w), mode=self.mode,
                                  align_corners=self.align_corners)
            return y.to(win.dtype)
        return resize2d(rows, (hi - lo, self.w), self.mode,
                        self.align_corners)

    def rows(self, devices: Sequence) -> Rows:
        """The resized map split over ``devices`` by the partition rule."""
        return Rows([self.fetch(a, b, d) for (a, b), d in
                     zip(split(self.h, len(devices)), devices)])


def resize(r: Rows, size, mode: str = "bilinear",
           align_corners: bool = False) -> Rows:
    """``ops/interpolate.resize`` on the sharded map."""
    if (r.h, r.parts[0].shape[3]) == tuple(int(s) for s in size):
        return r
    return Resized(r, size, mode, align_corners).rows(r.devices)


def upsample_nearest(r: Rows, factor: int = 2) -> Rows:
    """``ops/interpolate.upsample_nearest`` on the sharded map."""
    parts = []
    for (a, b), dev in zip(split(factor * r.h, r.k), r.devices):
        if a == b:
            parts.append(r.like(0, dev, width=factor * r.parts[0].shape[3]))
            continue
        s0 = a // factor
        win = r.fetch(s0, (b - 1) // factor + 1, dev)
        win = win.repeat_interleave(factor, dim=2)[:, :, a - factor * s0:
                                                   b - factor * s0]
        parts.append(win.repeat_interleave(factor, dim=3))
    return Rows(parts)


# ---- reductions over rows ------------------------------------------------

def total(values: Sequence[Optional[torch.Tensor]], devices: Sequence
          ) -> torch.Tensor:
    """The sum of the shards' partials (None for a shard with nothing to
    give) on the first device, with its gradient to each."""
    return all_reduce(values, "sum", devices[:1])[0]


def mean(r: Rows) -> torch.Tensor:
    """The per-(N, C) mean over the whole map, (N, C, 1, 1) on the first
    shard's device in the map's dtype: the shards' sums (in f32, float64
    for float64) added, then divided by h * w, with the gradient to every
    shard."""
    st = torch.promote_types(r.dtype, torch.float32)
    sums = [p.sum((2, 3), keepdim=True, dtype=st) if p.shape[2] else None
            for p in r.parts]
    return (total(sums, r.devices) / (r.h * r.w)).to(r.dtype)


def instance_norm(r: Rows, eps: float = 1e-5) -> Rows:
    """``norms.instance_norm`` over the whole map: the per-(N, C) mean from
    the shards' float64 sums, then the variance of the deviations from it;
    the statistics in f32 (float64 for float64) as the unsharded norm
    keeps them."""
    count = r.h * r.parts[0].shape[3]
    st = torch.promote_types(r.dtype, torch.float32)

    def sums(parts):
        return all_reduce([p.sum((2, 3), keepdim=True, dtype=torch.float64)
                           if p.shape[2] else None for p in parts], "sum",
                          r.devices)

    means = [(s / count).to(st) for s in sums(r.parts)]
    diffs = [p - m.to(p.dtype) for p, m in zip(r.parts, means)]
    vars_ = [(s / count).to(st) for s in sums([d * d for d in diffs])]
    return Rows([d * torch.rsqrt(v + eps).to(d.dtype)
                 for d, v in zip(diffs, vars_)])


def normalize(r: Rows, mini: float = 0.0, maxi: float = 1.0) -> Rows:
    """``ops/image.normalize`` (per-sample min-max over all non-batch dims)
    over the whole map: the global min is subtracted first, then the
    shifted global max divides, as the unsharded op does."""
    n = r.parts[0].shape[0]

    def reduce(parts, op):
        fn = torch.amin if op == "min" else torch.amax
        return [v.reshape(n, 1, 1, 1) for v in all_reduce(
            [fn(p.reshape(n, -1), dim=1) if p.shape[2] else None
             for p in parts], op, r.devices)]

    shifted = [p - m for p, m in zip(r.parts, reduce(r.parts, "min"))]
    return Rows([mini + (maxi - mini) * (t / m)
                 for t, m in zip(shifted, reduce(shifted, "max"))])
