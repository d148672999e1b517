"""The JAX package's PSPNet variables -> an mmseg state dict, and mmseg
checkpoints into the port's EncoderDecoder.

``flax_to_mmseg_state`` inverts ``peanut_tpu.core.checkpoint.
convert_encoder_decoder_state`` key for key, as the JAX package's
``export_encoder_decoder_to_torch`` does: flax conv kernels HWIO -> OIHW, BN
``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` -> ``weight``/``bias``
/``running_mean``/``running_var``.  It covers the ResNet/ResNetV1c
backbones, PSPHead and FCNHead, takes numpy arrays (or anything
``np.asarray`` reads; float64 stays float64, anything else becomes
float32) and raises on any variable it does not convert.  It
is how weights move between the two packages.  ``flax_train_state_to_torch``
moves a whole training state: the variables into the model, optax Adam's
moments and count into a ``torch.optim.Adam`` over it, and the step.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .checkpoint import load_torch_state_dict

_CONV_T = (3, 2, 0, 1)   # HWIO -> OIHW
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


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
    if top in ("decode_head", "auxiliary_head"):
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
            arr = np.asarray(value)
            if arr.dtype != np.float64:
                arr = arr.astype(np.float32)
            if arr.ndim == 4:
                arr = arr.transpose(_CONV_T)
            sd[name] = np.ascontiguousarray(arr)
    if left:
        raise KeyError(f"Unconverted flax variables: {left[:8]}")
    return sd


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
