"""The DeepLab v2 variant (``gen.encoder.architecture: deeplabv2``), NCHW:
the ResNetMulti encoder and the ASPP-with-image-pooling segmentation
decoder.

* ``DeeplabV2Encoder`` wraps ``ResNetMultiV2`` as ``model`` (keys
  ``encoder.model.*``): a stem of a 7x7 stride-2 conv, BN, relu and a 3x3
  stride-2 max pool with ceil mode and no padding; bottlenecks that stride
  on their first 1x1 conv; layer3 and layer4 dilated 2 and 4 at stride 1,
  every first block with a downsample; then ``n_res`` MUNIT ResBlocks
  (instance norms, lrelu, reflect padding) on the 2048 channels. Its batch
  norms' affine parameters are frozen (``FrozenBatchNorm2d``: buffers, so
  no optimizer steps them; train mode still normalizes by the batch
  statistics and advances the running ones).
* ``DeepLabV2Decoder``: ASPP branches at dilations 1, 6, 12, 18 and a
  global-average-pool branch, a 1x1 merge, then a head of two 3x3 convs
  with dropout and a 1x1 classifier, bilinear (align_corners) to the
  target size. In train mode dropout draws its masks from torch's
  generator of the device (``dropout``); on a row-sharded map each mask
  is drawn for the whole map on the first shard's device and sliced by
  rows, so the sharded forward drops what the unsharded one drops.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from climategan_torch.models.blocks import ResBlocks
from climategan_torch.models.norms import BatchNorm2d
from climategan_torch.ops.interpolate import resize
from climategan_torch.parallel import spatial
from climategan_torch.parallel.spatial import Rows


class FrozenBatchNorm2d(BatchNorm2d):
    """``BatchNorm2d`` whose ``weight`` and ``bias`` are buffers (the same
    state-dict keys): frozen, as the reference sets ``requires_grad=False``
    on them."""

    def __init__(self, num_features: int):
        super().__init__(num_features)
        weight, bias = self.weight.data, self.bias.data
        del self.weight, self.bias
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)


def max_pool_3x3_s2_ceil(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2, 0, ceil_mode=True)


def dropout_mask(shape, p: float, dtype, device) -> torch.Tensor:
    """A train-mode dropout mask of ``shape``: each value kept (1 / (1 -
    p)) with probability 1 - p, else 0, drawn from the device's
    generator."""
    keep = torch.empty(shape, dtype=dtype, device=device).bernoulli_(1.0 - p)
    return keep / (1.0 - p)


def dropout(y, p: float, training: bool):
    """Dropout of a tensor or a row-sharded map (one mask for the whole
    map, drawn on its first shard's device and sliced by rows); the
    identity in eval mode."""
    if not training:
        return y
    if not isinstance(y, Rows):
        return y * dropout_mask(y.shape, p, y.dtype, y.device)
    n, c, _, w = y.parts[0].shape
    mask = dropout_mask((n, c, y.h, w), p, y.dtype, y.devices[0])
    return Rows([t * mask[:, :, y.starts[i]:y.starts[i + 1]].to(t.device)
                 for i, t in enumerate(y.parts)])


class BottleneckV2(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                FrozenBatchNorm2d(planes * 4))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)

    def forward_rows(self, x: Rows) -> Rows:
        """The forward on a row-sharded map (conv1 strides)."""
        y = self.bn1.forward_rows(spatial.conv2d(x, self.conv1)).map(F.relu)
        y = self.bn2.forward_rows(spatial.conv2d(y, self.conv2)).map(F.relu)
        y = self.bn3.forward_rows(spatial.conv2d(y, self.conv3))
        residual = x if self.downsample is None else \
            self.downsample[1].forward_rows(
                spatial.conv2d(x, self.downsample[0]))
        return y.zip(residual, lambda a, b: F.relu(a + b))


class ResNetMultiV2(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), n_res: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes = 64
        cfg = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))
        for stage, (planes, stride, dilation) in enumerate(cfg):
            blocks = []
            for b in range(layers[stage]):
                first = b == 0
                blocks.append(BottleneckV2(
                    inplanes, planes, stride if first else 1, dilation,
                    downsample=first and (stride != 1 or inplanes != planes * 4
                                          or dilation in (2, 4))))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.layer_res = ResBlocks(n_res, 2048, "instance", "lrelu", "reflect")

    def forward(self, x, update_sn: bool = False):
        y = max_pool_3x3_s2_ceil(F.relu(self.bn1(self.conv1(x))))
        y = self.layer4(self.layer3(self.layer2(self.layer1(y))))
        return self.layer_res(y, update_sn)

    def forward_rows(self, x: Rows, update_sn: bool = False) -> Rows:
        """The forward on a row-sharded image: the stem's 7x7/2 conv and
        the ceil pool (its last window's overhang -inf) read across
        shards, as do layer3's and layer4's dilated convs."""
        y = self.bn1.forward_rows(spatial.conv2d(x, self.conv1)).map(F.relu)
        y = spatial.max_pool2d(y, 3, 2, 0, ceil_mode=True)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                y = block.forward_rows(y)
        return self.layer_res.forward_rows(y, update_sn)


class DeeplabV2Encoder(nn.Module):
    """Returns the single 2048-channel feature map at H/8."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), n_res: int = 4):
        super().__init__()
        self.model = ResNetMultiV2(layers, n_res)

    def forward(self, x):
        return self.model(x)

    def forward_rows(self, x: Rows) -> Rows:
        return self.model.forward_rows(x)


class ASPPModuleV2(nn.Module):
    def __init__(self, cin: int, planes: int, kernel: int, dilation: int):
        super().__init__()
        pad = 0 if kernel == 1 else dilation
        self.atrous_conv = nn.Conv2d(cin, planes, kernel, padding=pad,
                                     dilation=dilation, bias=False)
        self.bn = BatchNorm2d(planes)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))

    def forward_rows(self, x: Rows) -> Rows:
        return self.bn.forward_rows(spatial.conv2d(x, self.atrous_conv)).map(
            F.relu)


class ASPPV2(nn.Module):
    def __init__(self, cin: int = 2048, planes: int = 256):
        super().__init__()
        for i, (k, d) in enumerate(((1, 1), (3, 6), (3, 12), (3, 18))):
            setattr(self, f"aspp{i + 1}", ASPPModuleV2(cin, planes, k, d))
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(cin, planes, 1, bias=False),
            BatchNorm2d(planes), nn.ReLU())
        self.conv1 = nn.Conv2d(5 * planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)

    def forward(self, z):
        gap = self.global_avg_pool(z).expand(-1, -1, *z.shape[-2:])
        y = torch.cat([self.aspp1(z), self.aspp2(z), self.aspp3(z),
                       self.aspp4(z), gap], dim=1)
        y = F.relu(self.bn1(self.conv1(y)))
        return dropout(y, 0.5, self.training)

    def forward_rows(self, z: Rows) -> Rows:
        """The forward on a row-sharded map. The pooled branch is one 1x1
        map per image: the whole map's mean, then its conv, batch norm and
        relu once (in train mode a batch norm over k copies of it would
        take k times its gradient), broadcast to every shard's rows."""
        pooled = spatial.mean(z)
        _, conv, bn, relu = (self.global_avg_pool if self.training else
                             spatial.local(self.global_avg_pool,
                                           pooled.device))
        gap = relu(bn(conv(pooled.to(conv.weight.device))))
        feats = [m.forward_rows(z) for m in (self.aspp1, self.aspp2,
                                             self.aspp3, self.aspp4)]
        feats.append(Rows([gap.to(p.device).expand(-1, -1, p.shape[2],
                                                    p.shape[3])
                           for p in feats[0].parts]))
        y = spatial.conv2d(feats[0].cat(*feats[1:]), self.conv1)
        y = self.bn1.forward_rows(y).map(F.relu)
        return dropout(y, 0.5, self.training)


class DeepLabV2Decoder(nn.Module):
    def __init__(self, num_classes: int = 11, use_dada: bool = True,
                 target_size: Tuple[int, int] = (160, 160),
                 cin: int = 2048):
        super().__init__()
        self.use_dada = use_dada
        self.target_size = tuple(target_size)
        self.aspp = ASPPV2(cin)
        self.conv = nn.Sequential(
            nn.Conv2d(256, 256, 3, padding=1, bias=False), BatchNorm2d(256),
            nn.ReLU(), nn.Dropout(0.5),
            nn.Conv2d(256, 256, 3, padding=1, bias=False), BatchNorm2d(256),
            nn.ReLU(), nn.Dropout(0.1),
            nn.Conv2d(256, num_classes, 1))

    def forward(self, z, z_depth=None):
        if isinstance(z, (list, tuple)):
            z = z[0]
        if z_depth is not None and self.use_dada:
            z = z * z_depth
        y = self.aspp(z)
        for layer in self.conv:
            y = (dropout(y, layer.p, self.training)
                 if isinstance(layer, nn.Dropout) else layer(y))
        return resize(y, self.target_size, "bilinear", align_corners=True)

    def forward_rows(self, z, z_depth=None) -> Rows:
        """The forward on row-sharded maps."""
        if isinstance(z, (list, tuple)):
            z = z[0]
        if z_depth is not None and self.use_dada:
            z = z.zip(z_depth, torch.mul)
        y = self.aspp.forward_rows(z)
        for layer in self.conv:
            if isinstance(layer, nn.Dropout):
                y = dropout(y, layer.p, self.training)
            elif isinstance(layer, nn.Conv2d):
                y = spatial.conv2d(y, layer)
            elif isinstance(layer, BatchNorm2d):
                y = layer.forward_rows(y)
            else:
                y = y.map(layer)
        return spatial.resize(y, self.target_size, "bilinear",
                              align_corners=True)
