"""Weights into the port's state dict (the reference torch key layout).

``state_dict_from_jax(variables, cfg)`` takes the JAX package's
``{"params", "batch_stats", "spectral"}`` tree (arrays as numpy) and returns
torch tensors under the reference keys: HWIO kernels become OIHW; a conv
with spectral ``u``/``v`` becomes ``<key>.module.weight_bar`` /
``.module.bias`` / ``.module.weight_u`` / ``.module.weight_v``; a BatchNorm
wrapper's ``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
``running_mean``/``running_var`` (plus a zero ``num_batches_tracked``); a
batch norm without affine parameters (a SPADE's ``param_free_norm``) keeps
only the statistics.
It is the inverse of the JAX package's reference -> JAX converter, and
carries everything a train-mode model reads (running statistics, u/v).
``d_state_dict_from_jax(variables, dcfg)`` does the same for the
discriminators, and ``vgg_state_dict_from_jax(variables)`` for the JAX
package's ``VGG19Features`` (into torchvision's ``features.{i}`` keys).

``load_torch_state_dict(path)`` reads a released reference checkpoint and
``state_dict_from_reference(sd, cfg)`` turns its G state dict into exactly
the keys of ``OmniGenerator(cfg).state_dict()``, with the JAX package's
``convert_generator`` semantics for missing and partial module groups.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from climategan_torch.models.discriminator import DisConfig
from climategan_torch.models.generator import GenConfig, OmniGenerator
from climategan_torch.models.mobilenet import STAGES as MOBILENET_STAGES

Path = Tuple[str, ...]
Entry = Tuple[str, str, Path]  # (kind, torch key, JAX path)


def _conv2dblock(tkey: str, path: Path, batch: bool) -> Iterator[Entry]:
    yield "conv", f"{tkey}.conv", path + ("conv",)
    if batch:
        yield "bn", f"{tkey}.norm", path + ("norm", "BatchNorm_0")


def _convbn(tkey: str, path: Path) -> Iterator[Entry]:
    """A module with ``conv`` and a BatchNorm wrapper ``bn``."""
    yield "conv", f"{tkey}.conv", path + ("conv",)
    yield "bn", f"{tkey}.bn", path + ("bn", "BatchNorm_0")


def _resnet(t: str, e: Path, layers) -> Iterator[Entry]:
    """The dilated ResNet and the v2 ResNetMulti: every stage's first block
    has a downsample."""
    yield "conv", f"{t}.conv1", e + ("conv1",)
    yield "bn", f"{t}.bn1", e + ("bn1", "BatchNorm_0")
    for stage, n in enumerate(layers):
        for b in range(n):
            tb, p = f"{t}.layer{stage + 1}.{b}", e + (f"layer{stage + 1}_block{b}",)
            for i in (1, 2, 3):
                yield "conv", f"{tb}.conv{i}", p + (f"conv{i}",)
                yield "bn", f"{tb}.bn{i}", p + (f"bn{i}", "BatchNorm_0")
            if b == 0:
                yield "conv", f"{tb}.downsample.0", p + ("downsample_conv",)
                yield "bn", f"{tb}.downsample.1", p + ("downsample_bn", "BatchNorm_0")


def _mobilenet(t: str = "encoder", e: Path = ("encoder",)) -> Iterator[Entry]:
    yield from _convbn(f"{t}.conv1", e + ("conv1",))
    for s, groups in enumerate(MOBILENET_STAGES):
        j = 0
        for expand, _, n, _ in groups:
            for _ in range(n):
                tk, q = f"{t}.block{s + 1}.{j}.conv", e + (f"block{s + 1}_ir{j}",)
                li = 0
                if expand != 1:
                    yield from _convbn(f"{tk}.0", q + ("layer0",))
                    li = 1
                yield from _convbn(f"{tk}.{li}", q + (f"layer{li}",))
                yield "conv", f"{tk}.{li + 1}", q + ("project",)
                yield "bn", f"{tk}.{li + 2}", q + ("project_bn", "BatchNorm_0")
                j += 1


def _encoder(cfg: GenConfig) -> Iterator[Entry]:
    if cfg.encoder_arch == "deeplabv2":
        yield from _resnet("encoder.model", ("encoder",), cfg.encoder_layers)
        for r in range(cfg.encoder_n_res):
            for ci in (0, 1):
                yield from _conv2dblock(
                    f"encoder.model.layer_res.model.{r}.model.{ci}",
                    ("encoder", "layer_res", f"block{r}", f"conv{ci + 1}"), False)
    elif cfg.backbone == "mobilenet":
        yield from _mobilenet()
    else:
        yield from _resnet("encoder", ("encoder",), cfg.encoder_layers)


def _base_decoder(t: str, p: Path, n_res: int, n_up: int, batch: bool,
                  low_level: bool) -> Iterator[Entry]:
    """A BaseDecoder (``proj_conv``, the low-level convs, ``model``: the
    ResBlocks, then an upsample and a conv per step, then the output
    conv)."""
    yield from _conv2dblock(f"{t}.proj_conv", p + ("proj_conv",), batch)
    if low_level:
        for name in ("low_level_conv", "merge_feats_conv"):
            yield from _conv2dblock(f"{t}.{name}", p + (name,), batch)
    for r in range(n_res):
        for ci in (0, 1):
            yield from _conv2dblock(f"{t}.model.0.model.{r}.model.{ci}",
                                    p + ("res_blocks", f"block{r}", f"conv{ci + 1}"),
                                    batch)
    for u in range(n_up):
        yield from _conv2dblock(f"{t}.model.{2 + 2 * u}", p + (f"up_conv{u}",),
                                batch)
    yield from _conv2dblock(f"{t}.model.{1 + 2 * n_up}", p + ("out_conv",), False)


def _depth(cfg: GenConfig) -> Iterator[Entry]:
    p = ("depth_decoder",)
    if cfg.d_architecture != "dada":
        yield from _base_decoder("decoders.d", p + ("decoder",), 1,
                                 1 if cfg.d_upsample_featuremaps else 0, True,
                                 False)
        return
    for name in ("enc4_1", "enc4_2", "enc4_3"):
        yield from _conv2dblock(f"decoders.d.{name}", p + (name,), True)
    if cfg.m_use_dada or ("s" in cfg.tasks and cfg.s_use_dada):
        yield from _conv2dblock("decoders.d.dec4", p + ("dec4",), False)
    if cfg.d_upsample_featuremaps:
        yield from _conv2dblock("decoders.d.upsample.1", p + ("up_conv",), True)
        yield "conv", "decoders.d.upsample.2", p + ("up_out", "conv")


def _seg(cfg: GenConfig) -> Iterator[Entry]:
    p = ("seg_decoder",)
    if cfg.encoder_arch == "deeplabv2" or cfg.s_architecture == "deeplabv2":
        for i in (1, 2, 3, 4):
            yield "conv", f"decoders.s.aspp.aspp{i}.atrous_conv", p + (f"aspp{i}", "atrous_conv")
            yield "bn", f"decoders.s.aspp.aspp{i}.bn", p + (f"aspp{i}", "bn", "BatchNorm_0")
        yield "conv", "decoders.s.aspp.global_avg_pool.1", p + ("gap_conv",)
        yield "bn", "decoders.s.aspp.global_avg_pool.2", p + ("gap_bn", "BatchNorm_0")
        yield "conv", "decoders.s.aspp.conv1", p + ("conv1",)
        yield "bn", "decoders.s.aspp.bn1", p + ("bn1", "BatchNorm_0")
        for i, name in ((0, "head0"), (4, "head1")):
            yield "conv", f"decoders.s.conv.{i}", p + (name,)
            yield "bn", f"decoders.s.conv.{i + 1}", p + (f"{name}_bn", "BatchNorm_0")
        yield "conv", "decoders.s.conv.8", p + ("classifier",)
        return
    if cfg.backbone == "mobilenet":
        for i in (0, 1):
            t, q = f"decoders.s.head.block.{i}.block", p + ("head", f"sep{i}")
            for conv, bn in (("depthwise", "bn_depth"), ("pointwise", "bn_point")):
                yield "conv", f"{t}.{conv}", q + (conv,)
                yield "bn", f"{t}.{bn}", q + (bn, "BatchNorm_0")
        yield "conv", "decoders.s.head.block.2", p + ("head", "classifier")
        return
    convbns = [(f"aspp.{n}", ("aspp", n)) for n in
               ("conv1", "conv2", "conv3", "conv4", "conv_out")]
    convbns += [("decoder.conv_low", ("decoder", "conv_low"))]
    convbns += [(f"decoder.conv_cat.{i}", ("decoder", f"conv_cat{i}")) for i in (0, 1)]
    for t, q in convbns:
        yield "conv", f"decoders.s.{t}.conv", p + q + ("conv",)
        yield "bn", f"decoders.s.{t}.bn", p + q + ("bn", "BatchNorm_0")
    yield "conv", "decoders.s.decoder.conv_out", p + ("decoder", "conv_out")


def _spade_block(t: str, q: Path, learned: bool, batch: bool) -> Iterator[Entry]:
    convs = ("conv_0", "conv_1") + (("conv_s",) if learned else ())
    norms = ("norm_0", "norm_1") + (("norm_s",) if learned else ())
    for c in convs:
        yield "conv", f"{t}.{c}", q + (c,)
    for n in norms:
        yield "conv", f"{t}.{n}.mlp_shared.0", q + (n, "mlp_shared")
        yield "conv", f"{t}.{n}.mlp_gamma", q + (n, "mlp_gamma")
        yield "conv", f"{t}.{n}.mlp_beta", q + (n, "mlp_beta")
        if batch:
            yield "stats", f"{t}.{n}.param_free_norm", q + (n, "param_free_norm")


def _mask(cfg: GenConfig) -> Iterator[Entry]:
    if not cfg.m_use_spade:
        yield from _base_decoder(
            "decoders.m", ("mask_decoder", "decoder"), cfg.m_n_res,
            cfg.m_n_upsample, cfg.m_norm == "batch",
            cfg.m_use_low_level_feats and cfg.encoder_arch != "deeplabv2")
        return
    p = ("mask_decoder",)
    if cfg.encoder_arch == "deeplabv2":
        names = ("fc_conv",)
    else:
        names = ("low_level_conv",) + (("high_level_conv",) if cfg.m_use_proj
                                       else ()) + ("merge_feats_conv",)
    for name in names:
        yield from _conv2dblock(f"decoders.m.{name}", p + (name,), True)
    for i in range(cfg.m_spade_num_layers):
        yield from _spade_block(f"decoders.m.spade_blocks.{i}",
                                p + (f"spade_block{i}",), True, True)
    yield from _conv2dblock("decoders.m.mask_conv", p + ("mask_conv",), False)


def _painter(cfg: GenConfig) -> Iterator[Entry]:
    p = ("painter",)
    batch = cfg.p_spade_param_free_norm == "batch"
    if cfg.p_no_z:
        yield "conv", "painter.fc", p + ("fc",)
    blocks = [(n, n, False) for n in ("head_0", "G_middle_0", "G_middle_1")]
    blocks += [(f"up_spades.{i}", f"up_spade{i}", True)
               for i in range(cfg.p_spade_n_up - 2)]
    blocks += [("final_spade", "final_spade", False)]
    for tname, jname, learned in blocks:
        yield from _spade_block(f"painter.{tname}", p + (jname,), learned,
                                batch)
    if cfg.p_use_final_shortcut:
        yield "conv", "painter.final_shortcut_conv", p + ("final_shortcut_conv",)
        yield "bn", "painter.final_shortcut_bn", p + ("final_shortcut_bn",
                                                      "BatchNorm_0")
    yield "conv", "painter.conv_img", p + ("conv_img",)


def entries(cfg: GenConfig) -> Iterator[Entry]:
    """(kind, torch key prefix, JAX path) for every conv and batch norm
    ("conv", "bn", or "stats" for a batch norm without affine
    parameters)."""
    if any(t in cfg.tasks for t in "msd"):
        yield from _encoder(cfg)
    if "d" in cfg.tasks:
        yield from _depth(cfg)
    if "s" in cfg.tasks:
        yield from _seg(cfg)
    if "m" in cfg.tasks:
        yield from _mask(cfg)
    if "p" in cfg.tasks:
        yield from _painter(cfg)


def _get(tree, path: Path):
    node = tree
    for k in path:
        if not isinstance(node, dict) and not hasattr(node, "keys"):
            return None
        if k not in node:
            return None
        node = node[k]
    return node


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_jax(variables: Dict, cfg: GenConfig) -> Dict[str, torch.Tensor]:
    return state_dict_from_entries(variables, entries(cfg))


def state_dict_from_entries(variables: Dict, items: Iterable[Entry]
                            ) -> Dict[str, torch.Tensor]:
    """The torch tensors of ``items`` ((kind, torch key, JAX path), as
    ``entries`` yields them) from a JAX variable tree."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    spectral = variables.get("spectral", {})
    sd: Dict[str, torch.Tensor] = {}
    for kind, tkey, path in items:
        if kind in ("bn", "stats"):
            p, s = _get(params, path), _get(stats, path)
            if (p is None and kind == "bn") or s is None:
                raise KeyError(f"no batch norm at {'/'.join(path)}")
            if kind == "bn":
                sd[f"{tkey}.weight"] = _tensor(p["scale"])
                sd[f"{tkey}.bias"] = _tensor(p["bias"])
            sd[f"{tkey}.running_mean"] = _tensor(s["mean"])
            sd[f"{tkey}.running_var"] = _tensor(s["var"])
            sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
            continue
        _conv(sd, params, spectral, tkey, path)
    return sd


def _conv(sd, params, spectral, tkey: str, path: Path) -> None:
    """One conv's kernel (HWIO -> OIHW), bias and spectral u/v into
    ``sd``."""
    p = _get(params, path)
    if p is None or "kernel" not in p:
        raise KeyError(f"no conv kernel at {'/'.join(path)}")
    weight = _tensor(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    uv = _get(spectral, path)
    if uv is not None and "u" in uv:
        prefix = f"{tkey}.module"
        sd[f"{prefix}.weight_bar"] = weight
        sd[f"{prefix}.weight_u"] = _tensor(uv["u"])
        sd[f"{prefix}.weight_v"] = _tensor(uv["v"])
    else:
        prefix = tkey
        sd[f"{prefix}.weight"] = weight
    if "bias" in p:
        sd[f"{prefix}.bias"] = _tensor(p["bias"])


def d_entries(dcfg: DisConfig) -> Iterator[Tuple[str, Path]]:
    """(torch key prefix, JAX path) of every conv of the discriminators;
    the module names are the same on both sides."""
    if "p" in dcfg.tasks:
        for i in range(dcfg.p_num_D):
            q = ("p", f"discriminator_{i}")
            for k in [f"conv{n}" for n in range(dcfg.p_n_layers + 1)] + ["conv_out"]:
                yield ".".join(q + (k,)), q + (k,)
    for name, on in (("m_advent", dcfg.m_use_advent and "m" in dcfg.tasks),
                     ("s_advent", dcfg.s_use_advent and "s" in dcfg.tasks)):
        if on:
            for i in range(5):
                yield f"{name}.conv{i}", (name, f"conv{i}")


def d_state_dict_from_jax(variables: Dict,
                          dcfg: DisConfig) -> Dict[str, torch.Tensor]:
    """The JAX discriminators' ``{"params", "spectral"}`` (numpy) -> the
    port's ``OmniDiscriminator(dcfg).state_dict()``."""
    sd: Dict[str, torch.Tensor] = {}
    for tkey, path in d_entries(dcfg):
        _conv(sd, variables["params"], variables.get("spectral", {}), tkey,
              path)
    return sd


# torchvision vgg19.features indices of the 13 convs VGG19Features keeps
VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)


def vgg_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX ``VGG19Features`` params (numpy) -> the port's
    ``VGG19Features`` state dict (torchvision's keys)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, ti in enumerate(VGG_CONV_INDICES):
        _conv(sd, variables["params"], {}, f"features.{ti}", (f"conv{i}",))
    return sd


def load_torch_state_dict(path, allow_pickle: bool = False) -> Dict[str, Any]:
    """Load a torch checkpoint safely: ``weights_only=True`` first (plain
    tensor state dicts, as the released ClimateGAN checkpoints are), and
    an unpickling load only with ``allow_pickle=True``, since that runs
    code from the file. Unwraps ``{"G": ...}`` and ``{"state_dict": ...}``."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_pickle:
            raise RuntimeError(
                f"{path} is not a plain-tensor checkpoint (weights_only load "
                f"failed: {e}). If you trust this file, retry with "
                f"allow_pickle=True.") from e
        warnings.warn(f"falling back to unsafe pickle load for {path}; this "
                      f"executes code embedded in the checkpoint", stacklevel=2)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "G" in ckpt:
        return ckpt["G"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


# (name, key prefix, part) of each module group, in the order of the JAX
# package's convert_generator
GROUPS = (("encoder", "encoder.", "masker"),
          ("depth decoder", "decoders.d.", "masker"),
          ("seg decoder", "decoders.s.", "masker"),
          ("mask decoder", "decoders.m.", "masker"),
          ("painter", "painter.", "painter"))


def _zero_state_dict(cfg: GenConfig) -> Dict[str, torch.Tensor]:
    """Every key of ``OmniGenerator(cfg).state_dict()`` as zeros (the model
    is built on the meta device, so no weights are allocated)."""
    with torch.device("meta"):
        template = OmniGenerator(cfg).state_dict()
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in template.items()}


def state_dict_from_reference(
    sd: Mapping[str, Any], cfg: GenConfig,
    parts: Tuple[str, ...] = ("masker", "painter"), lenient: bool = False,
    into: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """A reference G state dict -> exactly the keys of
    ``OmniGenerator(cfg).state_dict()``, as the JAX package's
    ``convert_generator`` reads it: a leading ``G.`` is stripped and unknown
    keys are ignored. Groups outside ``parts`` (``"masker"``: encoder and
    the d/s/m decoders; ``"painter"``) take their values from ``into``.
    A group with no key in ``sd`` raises, or with ``lenient`` warns and
    keeps ``into``'s values; a group only partly present always raises.
    Without ``into`` the kept values are zeros, as the JAX package's
    ``init_generator_variables`` leaves them (zero spectral u/v: such a
    module cannot run). ``num_batches_tracked`` is optional, as the JAX
    converter never reads it. Values take the template's dtype."""
    if any(k.startswith("G.") for k in sd):
        sd = {k[2:] if k.startswith("G.") else k: v for k, v in sd.items()}
    base = _zero_state_dict(cfg) if into is None else into
    out = {}
    for group, prefix, part in GROUPS:
        keys = [k for k in base if k.startswith(prefix)]
        if not keys:
            continue
        load = part in parts
        if load and not any(k.startswith(prefix) for k in sd):
            if not lenient:
                raise KeyError(f"state dict has no {prefix!r}* keys for the "
                               f"{group} (pass lenient=True to keep init values)")
            warnings.warn(f"checkpoint has no {prefix!r}* keys: keeping init "
                          f"values for the {group} (reference strict=False "
                          f"inference load)", stacklevel=2)
            load = False
        if not load:
            out.update((k, base[k]) for k in keys)
            continue
        missing = [k for k in keys if k not in sd
                   and not k.endswith(".num_batches_tracked")]
        if missing:
            raise KeyError(f"the {group} is only partly in the state dict: "
                           f"{len(missing)} of {len(keys)} keys missing, e.g. "
                           f"{missing[:3]}")
        for k in keys:
            if k not in sd:
                out[k] = base[k]
                continue
            v = torch.as_tensor(sd[k])
            if tuple(v.shape) != tuple(base[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} in the state "
                                 f"dict, {tuple(base[k].shape)} in the model")
            out[k] = v.detach().to(device="cpu", dtype=base[k].dtype).clone()
    return out


# ---------------------------------------------------------------------------
# pretrained weights for training: the DeepLab backbone and seg head
# (reference deeplab/__init__.py:54-101, deeplab_v3.py:193-230) and
# torchvision's VGG19 for the perceptual loss
# ---------------------------------------------------------------------------


def _without_classifier(sd: Mapping[str, Any], prefixes: Tuple[str, ...],
                        classifier: str, skip_classes: int
                        ) -> Dict[str, torch.Tensor]:
    """The keys of ``sd`` under ``prefixes`` (``num_batches_tracked`` not
    read, as the JAX converters read it not), under the seg decoder's
    prefix, without the classifier at ``classifier`` when it has
    ``skip_classes`` outputs (the source's 19 classes)."""
    out = {}
    skip = (f"{classifier}.weight" in sd
            and sd[f"{classifier}.weight"].shape[0] == skip_classes)
    for k, v in sd.items():
        if not k.startswith(prefixes) or k.endswith(".num_batches_tracked"):
            continue
        if skip and k.startswith(classifier + "."):
            continue
        out["decoders.s." + k] = torch.as_tensor(v)
    return out


def convert_pretrained_seg_resnet(sd: Mapping[str, Any],
                                  skip_classes: int = 19
                                  ) -> Dict[str, torch.Tensor]:
    """A pretrained DeepLabv3+ (resnet) state dict's ``aspp.*`` and
    ``decoder.*`` keys under the seg decoder's (``decoders.s.``), without
    the source's 19-class classifier (deeplab_v3.py:197-216)."""
    return _without_classifier(sd, ("aspp.", "decoder."), "decoder.conv_out",
                               skip_classes)


def convert_pretrained_seg_mobilenet(sd: Mapping[str, Any],
                                     skip_classes: int = 19
                                     ) -> Dict[str, torch.Tensor]:
    """A pretrained mobilenet DeepLab's ``head.block.*`` keys under the seg
    decoder's, without the source's 19-class classifier
    (``head.block.2``, deeplab_v3.py:218-230)."""
    return _without_classifier(sd, ("head.",), "head.block.2", skip_classes)


def maybe_load_pretrained_backbone(opts, G: OmniGenerator) -> bool:
    """Honour ``gen.deeplabv3.use_pretrained`` (its
    ``pretrained_model.{resnet,mobilenet}`` path) and
    ``gen.deeplabv2.use_pretrained`` (its ``pretrained_model`` path), as the
    JAX package's loader does (reference defaults.yaml:108-120,
    deeplab/__init__.py:54-101), in place; returns whether it loaded.

    * resnet: the ``backbone.*`` keys into the encoder, every encoder key
      required; with the seg task, the ``aspp.*``/``decoder.*`` keys into
      the seg decoder;
    * mobilenet: the file's keys (a leading ``encoder.`` dropped) into the
      encoder where the model has them, at least one required (the
      reference updates the intersection); with the seg task, the
      ``head.*`` keys into the seg decoder;
    * deeplabv2: each key's first component dropped, ``layer5.*`` and
      ``resblock.*`` skipped, the rest into the ResNetMulti encoder, every
      key of its ResNet required (its trailing ResBlocks keep their
      values).

    Other keys of the file are ignored; the classifier of the source's 19
    classes is not loaded."""
    from pathlib import Path as FilePath

    g = opts.gen
    if not any(t in (opts.tasks or ()) for t in "msd"):
        return False
    v2 = g.encoder.get("architecture", "deeplabv3") == "deeplabv2"
    conf = g.deeplabv2 if v2 else g.deeplabv3
    if not conf.get("use_pretrained"):
        return False
    backbone = "resnet" if v2 else conf.get("backbone", "resnet")
    pm = conf.get("pretrained_model") or {}
    path = str(pm.get(backbone, "") if isinstance(pm, Mapping) else pm)
    name = ("gen.deeplabv2.pretrained_model" if v2
            else f"gen.deeplabv3.pretrained_model.{backbone}")
    if not path or not FilePath(path).exists():
        raise FileNotFoundError(f"{name} {path!r} does not exist")
    sd = load_torch_state_dict(path)
    has_seg = "s" in opts.tasks and g.s.get("architecture",
                                            "deeplabv3") == "deeplabv3"
    if v2:
        new, required = {}, "encoder.model."
        for k, v in sd.items():
            parts = k.split(".")
            if len(parts) > 1 and parts[1] in ("layer5", "resblock"):
                continue
            new["encoder.model." + ".".join(parts[1:])] = torch.as_tensor(v)
    elif backbone == "mobilenet":
        new, required = {"encoder." + k.replace("encoder.", "", 1):
                         torch.as_tensor(v) for k, v in sd.items()}, None
        if has_seg:
            new.update(convert_pretrained_seg_mobilenet(sd))
    else:
        new, required = {"encoder." + k[len("backbone."):]: torch.as_tensor(v)
                         for k, v in sd.items()
                         if k.startswith("backbone.")}, "encoder."
        if has_seg:
            new.update(convert_pretrained_seg_resnet(sd))
    target = G.state_dict()
    new = {k: v for k, v in new.items()
           if k in target and not k.endswith(".num_batches_tracked")}
    if required is not None:
        missing = [k for k in target if k.startswith(required)
                   and ".layer_res." not in k and k not in new
                   and not k.endswith(".num_batches_tracked")]
        if missing:
            raise KeyError(f"{path}: {len(missing)} encoder keys missing, "
                           f"e.g. {missing[:3]}")
    elif not any(k.startswith("encoder.") for k in new):
        raise ValueError(f"no {backbone} backbone weights matched in "
                         f"{path!r} ({len(sd)} keys present)")
    for k, v in new.items():
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, "
                             f"the model {tuple(target[k].shape)}")
    G.load_state_dict({**target, **new}, strict=True)
    return True


def load_vgg19_weights(path, vgg: torch.nn.Module) -> torch.nn.Module:
    """A torchvision vgg19 state dict into ``losses.VGG19Features`` (whose
    keys are torchvision's), conv by conv up to the first one the file
    lacks, as the JAX package's loader reads it."""
    sd = load_torch_state_dict(path)
    own = vgg.state_dict()
    new = {}
    for ti in VGG_CONV_INDICES:
        if f"features.{ti}.weight" not in sd:
            break
        for kind in ("weight", "bias"):
            new[f"features.{ti}.{kind}"] = torch.as_tensor(
                sd[f"features.{ti}.{kind}"])
    vgg.load_state_dict({**own, **new}, strict=True)
    return vgg
