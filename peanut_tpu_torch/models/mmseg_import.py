"""The JAX package's PSPNet variables -> an mmseg state dict, and mmseg
checkpoints into the port's EncoderDecoder.

``flax_to_mmseg_state`` inverts ``peanut_tpu.core.checkpoint.
convert_encoder_decoder_state`` key for key, as the JAX package's
``export_encoder_decoder_to_torch`` does: flax conv kernels HWIO -> OIHW, BN
``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` -> ``weight``/``bias``
/``running_mean``/``running_var``.  It covers the zoo's ResNet
backbones (ResNet, ResNetV1c, ResNeXt), PSPHead and FCNHead, takes numpy
arrays (or anything ``np.asarray`` reads; float64 stays float64,
anything else becomes float32) and raises on any variable it does not
convert.  It is how weights move between the two packages.
``flax_to_torch_state`` carries a whole zoo segmentor: those parts by
their mmseg names, the zoo's other backbones, necks and heads (named
after their flax modules in the port) by one generic rule.
``flax_train_state_to_torch`` moves a whole training state: the
variables into the model, optax Adam's moments and count into a
``torch.optim.Adam`` over it, and the step.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from .checkpoint import load_torch_state_dict
from .heads import FCNHead, PSPHead
from .heads_zoo import MaskConv
from .layers import BatchNorm
from .resnet import BasicBlock, ZooBottleneck, ZooResNet

_CONV_T = (3, 2, 0, 1)   # HWIO -> OIHW
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _array(value) -> np.ndarray:
    arr = np.asarray(value)
    return arr if arr.dtype == np.float64 else arr.astype(np.float32)


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unit(head: str, sub: str):
    """The mmseg name of a head's ConvModule, or None."""
    m = re.fullmatch(r"ppm(\d+)", sub)
    if m:
        return f"{head}.psp_modules.{m.group(1)}.1"
    m = re.fullmatch(r"convs(\d+)", sub)
    if m:
        return f"{head}.convs.{m.group(1)}"
    if sub in ("bottleneck", "conv_cat"):
        return f"{head}.{sub}"
    return None


def _mmseg_name(path: Tuple[str, ...]):
    """mmseg parameter name of one flax variable path, or None."""
    top, sub, rest = path[0], path[1], path[2:]
    leaf = path[-1]
    if top == "backbone":
        m = re.fullmatch(r"stem(\d)", sub)
        if m:
            k = int(m.group(1))
            if rest == ("conv_unit", "conv", "kernel"):
                return f"backbone.stem.{3 * k}.weight"
            if rest[:2] == ("norm", "bn"):
                return f"backbone.stem.{3 * k + 1}.{_BN[leaf]}"
            return None
        if path == ("backbone", "conv1", "conv", "kernel"):
            return "backbone.conv1.weight"
        if path[:3] == ("backbone", "bn1", "bn"):
            return f"backbone.bn1.{_BN[leaf]}"
        m = re.fullmatch(r"layer(\d+)_(\d+)", sub)
        if not m:
            return None
        block = f"backbone.layer{m.group(1)}.{m.group(2)}"
        part = rest[0]
        if re.fullmatch(r"conv\d", part) and rest[1:] == ("conv", "kernel"):
            return f"{block}.{part}.weight"
        if part == "downsample_conv" and rest[1:] == ("conv", "kernel"):
            return f"{block}.downsample.0.weight"
        if re.fullmatch(r"bn\d", part) and rest[1] == "bn":
            return f"{block}.{part}.{_BN[leaf]}"
        if part == "downsample_bn" and rest[1] == "bn":
            return f"{block}.downsample.1.{_BN[leaf]}"
        return None
    if re.fullmatch(r"decode_head\d*|auxiliary_head", top):
        if sub == "conv_seg" and rest[0] == "conv":
            return f"{top}.conv_seg.{'weight' if leaf == 'kernel' else 'bias'}"
        unit = _unit(top, sub)
        if unit is None:
            return None
        if rest == ("conv_unit", "conv", "kernel"):
            return f"{unit}.conv.weight"
        if rest[:2] == ("norm", "bn"):
            return f"{unit}.bn.{_BN[leaf]}"
    return None


def flax_to_mmseg_state(variables: Mapping[str, Any]
                        ) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    left = []
    for col in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(col, {})):
            name = _mmseg_name(path) if len(path) > 2 else None
            if name is None or name in sd:
                left.append("/".join((col,) + path))
                continue
            arr = _array(value)
            if arr.ndim == 4:
                arr = arr.transpose(_CONV_T)
            sd[name] = np.ascontiguousarray(arr)
    if left:
        raise KeyError(f"Unconverted flax variables: {left[:8]}")
    return sd


# flax's leaf names on the port's module types
_LEAF = {"conv": {"kernel": "weight", "bias": "bias"},
         "dense": {"kernel": "weight", "bias": "bias"},
         "bn": {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"},
         "ln": {"scale": "weight", "bias": "bias"}}


def _kind(m: torch.nn.Module):
    if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, MaskConv)):
        return "conv"
    if isinstance(m, torch.nn.Linear):
        return "dense"
    if isinstance(m, BatchNorm):
        return "bn"
    if isinstance(m, torch.nn.LayerNorm):
        return "ln"
    return None


def _resnet_name(mod: torch.nn.Module, rest: Tuple[str, ...]):
    """The port's name, under ``mod`` (a zoo ResNet or one of its blocks),
    of the flax variable path ``rest`` below it, or None.  The blocks keep
    mmseg's names wherever they sit (``conv1``, ``bn1``,
    ``downsample.0`` / ``.1`` for flax's ``downsample_conv`` /
    ``downsample_bn``), so that a block is one module with one state-dict
    layout, top-level or nested (BiSeNetV1's context path, HRNet's and
    ICNet's blocks), and an mmseg checkpoint's blocks load into it; the
    rest of the path goes through ``_mmseg_name``'s rule, as under a
    top-level ResNet."""
    if isinstance(mod, ZooResNet):
        name, prefix = _mmseg_name(("backbone",) + rest), "backbone."
    else:
        name = _mmseg_name(("backbone", "layer1_0") + rest)
        prefix = "backbone.layer1.0."
    return None if name is None else name[len(prefix):]


def _generic_name(model: torch.nn.Module, path: Tuple[str, ...]):
    """The port's name of one flax variable of a zoo module, or None.  The
    port names its submodules after the flax ones; flax's wrappers fold
    away: a ConvModule's ``conv_unit/conv`` is the port's ``conv`` and its
    ``norm/bn`` the port's ``bn``, and the inner ``conv`` of a ``Conv2d``
    (``bn`` of a ``BatchNorm``) is the port's conv (batch norm) itself.
    Below a zoo ResNet or a block of one, the rest of the path takes
    mmseg's names (``_resnet_name``).  The leaf maps by the port module's
    type (``_LEAF``); a bare parameter (a gate, a codebook, a basis, a
    positional embedding, a PReLU's slope) keeps its name.  Returns the
    name and the port module that holds it."""
    mod, names = model, []
    for i, c in enumerate(path[:-1]):
        if isinstance(mod, (ZooResNet, ZooBottleneck, BasicBlock)):
            sub = _resnet_name(mod, path[i:])
            if sub is None:
                return None
            owner, leaf = sub.rpartition(".")[::2]
            mod = mod.get_submodule(owner)
            if leaf not in mod._parameters and leaf not in mod._buffers:
                return None
            return ".".join(names + [sub]), mod
        child = mod._modules.get(c)
        if child is not None:
            mod = child
            names.append(c)
        elif c in ("conv", "bn") and _kind(mod) == c:
            continue
        elif c in ("conv_unit", "norm") and mod._modules.get(
                {"conv_unit": "conv", "norm": "bn"}[c]) is not None:
            c = {"conv_unit": "conv", "norm": "bn"}[c]
            mod = mod._modules[c]
            names.append(c)
        else:
            return None
    kind = _kind(mod)
    leaf = _LEAF[kind].get(path[-1]) if kind else path[-1]
    if leaf is None or not (leaf in mod._parameters or leaf in mod._buffers):
        return None
    return ".".join(names + [leaf]), mod


def _port_layout(arr: np.ndarray, mod: torch.nn.Module, leaf: str):
    """A flax variable in the layout of the port module ``mod`` that
    receives it as ``leaf``: a conv kernel (spatial..., in, out) as (out,
    in, spatial...), whatever its rank (2-D, and the 1-D convs of
    PointHead); a dense kernel, flax's (in..., out...) with its input and
    output axes possibly split (``MultiHeadDotProductAttention``'s
    (C, heads, head_dim) and (heads, head_dim, C)), as the (out, in)
    weight of the ``nn.Linear``, and its bias flat; anything else (norms,
    a positional embedding, a table, a gate) as it is."""
    kind = _kind(mod)
    if kind == "conv" and leaf == "weight":
        nd = arr.ndim
        return arr.transpose((nd - 1, nd - 2) + tuple(range(nd - 2)))
    if kind == "dense" and leaf == "weight":
        return arr.reshape(mod.in_features, mod.out_features).T
    if kind == "dense":
        return arr.reshape(mod.out_features)
    return arr


def flax_to_torch_state(variables: Mapping[str, Any],
                        model: torch.nn.Module,
                        keep: Sequence[str] = ()) -> Dict[str, np.ndarray]:
    """The JAX package's variables of a zoo segmentor ({"params",
    "batch_stats"}, numpy or anything ``np.asarray`` reads) as a state
    dict of the port's ``model`` built from the same config; or of one
    module of the zoo, rooted there (a backbone and the tree a weight
    converter gives it: ``zoo_import.converted_backbone_state``).  The zoo's
    ResNets, PSPHead and FCNHead go by their mmseg names
    (``flax_to_mmseg_state``'s rule); the rest by ``_generic_name``, in
    the layout of the port module that receives each (``_port_layout``:
    conv kernels by the conv's rank, dense kernels transposed, attention
    kernels reshaped, other parameters as they are), batch and layer
    norms' ``scale`` -> ``weight`` and the batch statistics ``mean`` /
    ``var`` -> ``running_mean`` / ``running_var``.  float64 stays
    float64, anything else becomes float32.  Raises KeyError on any flax
    variable it does not place and on any parameter or buffer of
    ``model`` left unset, but those whose name matches one of the
    regular expressions ``keep``, which keep ``model``'s own values."""
    sd: Dict[str, np.ndarray] = {}
    left = []
    for col in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(col, {})):
            top = model._modules.get(path[0])
            arr = _array(value)
            if isinstance(top, (ZooResNet, PSPHead, FCNHead)):
                name = _mmseg_name(path) if len(path) > 2 else None
                if arr.ndim == 4:
                    arr = arr.transpose(_CONV_T)
            else:
                found = _generic_name(model, path)
                name = None
                if found is not None:
                    name, mod = found
                    arr = _port_layout(arr, mod, name.rsplit(".", 1)[-1])
            if name is None or name in sd:
                left.append("/".join((col,) + path))
                continue
            sd[name] = np.ascontiguousarray(arr)
    if left:
        raise KeyError(f"Unconverted flax variables: {left[:8]}")
    own = model.state_dict()
    for name in set(own) - set(sd):
        if any(re.fullmatch(p, name) for p in keep):
            sd[name] = own[name].detach().cpu().numpy()
    unset = sorted(set(own) - set(sd))
    if unset:
        raise KeyError(f"Port parameters or buffers left unset: {unset[:8]}")
    return sd


_BN_FLAX = {v: k for k, v in _BN.items()}


def _block_path(name: str):
    """The flax path below a residual block of an mmseg-named block
    parameter (``_mmseg_name``'s rule read backwards), or None."""
    m = re.fullmatch(r"(conv\d)\.weight", name)
    if m:
        return (m.group(1), "conv", "kernel")
    m = re.fullmatch(r"(bn\d)\.(\w+)", name)
    if m:
        return (m.group(1), "bn", _BN_FLAX[m.group(2)])
    if name == "downsample.0.weight":
        return ("downsample_conv", "conv", "kernel")
    m = re.fullmatch(r"downsample\.1\.(\w+)", name)
    if m:
        return ("downsample_bn", "bn", _BN_FLAX[m.group(1)])
    return None


def _resnet_path(name: str):
    """The flax path below a zoo ResNet of one of its mmseg-named
    parameters, or None."""
    m = re.fullmatch(r"stem\.(\d+)\.(\w+)", name)
    if m:
        k, r = divmod(int(m.group(1)), 3)
        return ((f"stem{k}", "conv_unit", "conv", "kernel") if r == 0
                else (f"stem{k}", "norm", "bn", _BN_FLAX[m.group(2)]))
    if name == "conv1.weight":
        return ("conv1", "conv", "kernel")
    m = re.fullmatch(r"bn1\.(\w+)", name)
    if m:
        return ("bn1", "bn", _BN_FLAX[m.group(1)])
    m = re.fullmatch(r"layer(\d+)\.(\d+)\.(.+)", name)
    if m:
        rest = _block_path(m.group(3))
        return None if rest is None else (
            f"layer{m.group(1)}_{m.group(2)}",) + rest
    return None


def _head_path(name: str):
    """The flax path below PSPHead or FCNHead of an mmseg-named
    parameter, or None."""
    m = re.fullmatch(r"conv_seg\.(weight|bias)", name)
    if m:
        return ("conv_seg", "conv",
                "kernel" if m.group(1) == "weight" else "bias")
    m = re.fullmatch(r"(psp_modules\.(\d+)\.1|convs\.(\d+)|bottleneck"
                     r"|conv_cat)\.(conv|bn)\.(\w+)", name)
    if not m:
        return None
    unit = (f"ppm{m.group(2)}" if m.group(2) is not None else
            f"convs{m.group(3)}" if m.group(3) is not None else m.group(1))
    if m.group(4) == "conv":
        return (unit, "conv_unit", "conv", "kernel")
    return (unit, "norm", "bn", _BN_FLAX[m.group(5)])


def flax_param_paths(model: torch.nn.Module
                     ) -> Dict[str, Tuple[str, ...]]:
    """The JAX package's variable path of every parameter of the zoo
    segmentor ``model``: {port name: flax path}, ``flax_to_torch_state``'s
    name map read backwards, so that rules written over flax paths
    (the layer-decay optimizer's) read the names the JAX package reads.
    The zoo's ResNets, their blocks wherever they sit, PSPHead and
    FCNHead go back from mmseg's names; elsewhere a ConvModule's ``conv``
    / ``bn`` are flax's ``conv_unit/conv`` / ``norm/bn``, and the leaf
    takes flax's name by the module that holds it (a kernel, a norm's
    ``scale``).  Where flax wraps a bare layer in a module of its own
    name (a ``conv`` in a ``conv``), the path leaves the wrapper out: the
    map sends it to the same parameter.  Every path is checked by
    sending it forward through the map; one that does not come back to
    its parameter raises KeyError.  Parameters still unbound
    (``layers.InputShaped``) are not listed."""
    from .layers import ConvModule

    out: Dict[str, Tuple[str, ...]] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        path = None
        top = model._modules.get(parts[0])
        if isinstance(top, (PSPHead, FCNHead)):
            rest = _head_path(".".join(parts[1:]))
            path = None if rest is None else (parts[0],) + rest
        else:
            mod, names = model, []
            for i, c in enumerate(parts[:-1]):
                if isinstance(mod, (ZooResNet, ZooBottleneck, BasicBlock)):
                    below = ".".join(parts[i:])
                    rest = (_resnet_path(below) if isinstance(mod, ZooResNet)
                            else _block_path(below))
                    path = None if rest is None else tuple(names) + rest
                    break
                if isinstance(mod, ConvModule) and c in ("conv", "bn"):
                    names += {"conv": ["conv_unit", "conv"],
                              "bn": ["norm", "bn"]}[c]
                else:
                    names.append(c)
                mod = mod._modules[c]
            else:
                kind = _kind(mod)
                leaf = parts[-1]
                if kind is not None:
                    leaf = {v: k for k, v in _LEAF[kind].items()}[leaf]
                path = tuple(names) + (leaf,)
        back = None
        if path is not None:
            if isinstance(top, (ZooResNet, PSPHead, FCNHead)):
                back = _mmseg_name(path)
            else:
                found = _generic_name(model, path)
                back = found[0] if found is not None else None
        if back != name:
            raise KeyError(f"no flax path of {name!r} maps back to it "
                           f"({path})")
        out[name] = path
    return out


def flax_train_state_to_torch(tree: Mapping[str, Any],
                              model: torch.nn.Module,
                              optimizer: torch.optim.Adam) -> int:
    """A JAX ``prediction.train.TrainState`` held as numpy trees --
    {"step", "params", "batch_stats", "mu", "nu", "count"} with ``mu``,
    ``nu`` and ``count`` from optax Adam's ``ScaleByAdamState`` -- into
    ``model`` (its parameters and running statistics) and ``optimizer``
    (each parameter's ``exp_avg``, ``exp_avg_sq`` and ``step``), which
    must be a ``torch.optim.Adam`` over ``model.parameters()``.  Returns
    the step, for the port's ``TrainState``.  The moments go through
    ``flax_to_mmseg_state`` like the parameters they belong to."""
    load_mmseg_state(model, flax_to_mmseg_state(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}))
    mu = flax_to_mmseg_state({"params": tree["mu"]})
    nu = flax_to_mmseg_state({"params": tree["nu"]})
    count = float(np.asarray(tree["count"]))
    params = dict(model.named_parameters())
    if set(params) != set(mu) or set(mu) != set(nu):
        raise KeyError(f"Adam moments do not match the model's parameters: "
                       f"{sorted(set(params) ^ set(mu))[:8]}")
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in params.items():
        if id(p) not in owned:
            raise ValueError(f"{name} is not a parameter of the optimizer")
        optimizer.state[p] = {
            "step": torch.tensor(count),
            "exp_avg": torch.tensor(mu[name]).to(p),
            "exp_avg_sq": torch.tensor(nu[name]).to(p)}
    return int(np.asarray(tree["step"]))


def load_mmseg_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """An mmseg checkpoint (``pred_model_wts``) as {name: numpy array};
    FileNotFoundError naming the path when it is missing."""
    return load_torch_state_dict(path, "PSPNet", "pred_model_wts")


def load_mmseg_state(model: torch.nn.Module,
                     sd: Mapping[str, Any]) -> torch.nn.Module:
    """Load an mmseg state dict (numpy or tensors) into ``model``; raises
    on missing or unexpected parameters (BN's ``num_batches_tracked``
    counters are training state and are dropped)."""
    state = {k: torch.tensor(np.asarray(v)) for k, v in sd.items()
             if not k.endswith("num_batches_tracked")}
    model.load_state_dict(state, strict=True)
    return model
