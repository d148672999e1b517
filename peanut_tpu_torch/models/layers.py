"""Building-block layers (NCHW) with detectron2's and mmcv's module layouts
(port of ``peanut_tpu.models.layers``).

``Conv2d`` carries its normalisation as a ``norm`` submodule, as detectron2's
wrapper does, so a d2 state dict (``...conv1.weight``, ``...conv1.norm.*``)
loads through ``load_state_dict``; ``ConvModule`` is mmcv's conv + BN + ReLU
unit (``...conv.weight``, ``...bn.*``) for the mmseg models; a bare
convolution (the flax ``Conv2d``) is ``nn.Conv2d``.  ``BatchNorm``
is flax's ``nn.BatchNorm`` (eps 1e-5, momentum 0.9): in eval mode the
frozen batch norm of inference, in train mode batch statistics and a
running-average update.  ``remat`` runs a block under
``torch.utils.checkpoint`` as ``nn.remat`` does in the JAX package.

The light CNNs' pieces, each in the JAX package's form: ``PReLU``
(flax's: one 0-D slope, 0.01 at init), ``hswish``, ``hsigmoid`` and
``relu6`` written as the JAX package writes them, and a ConvModule's
``act``.

The transformers' pieces: ``LayerNorm`` (flax's epsilon, 1e-6), ``gelu``
(each call site names its form: flax's default is the tanh approximation,
torch's the exact erf), ``MultiHeadAttention`` (flax's
``MultiHeadDotProductAttention``), ``SameConv2d`` (flax's ``nn.Conv``
with its default ``"SAME"`` padding) and ``InputShaped``, the base of a
module whose parameter takes its shape from the first input, as flax
shapes a variable at init.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


BN_EPS = 1e-5
BN_MOMENTUM = 0.9     # flax's: running = 0.9 * running + 0.1 * batch

_remat = threading.local()


@contextlib.contextmanager
def _recomputing():
    prev = getattr(_remat, "active", False)
    _remat.active = True
    try:
        yield
    finally:
        _remat.active = prev


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in backward
    (``torch.utils.checkpoint``, non-reentrant), as ``nn.remat`` wraps a
    residual block in the JAX package.  The recomputation runs with a
    flag set that keeps train-mode batch norms from updating their
    running statistics a second time (``nn.remat`` updates them once)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing()))


class BatchNorm(nn.Module):
    """BatchNorm2d as flax's ``nn.BatchNorm``: (x - mean) * (rsqrt(var +
    eps) * weight) + bias.  Eval mode: the running statistics (frozen, the
    serving path).  Train mode: the batch's mean over (N, H, W) and its
    biased variance E[x^2] - E[x]^2 clipped at 0 (flax's
    ``use_fast_variance``), and running = 0.9 * running + 0.1 * batch for
    both, the biased variance included (``nn.BatchNorm2d`` would average
    the unbiased one); not again while ``remat`` recomputes.  ``weight``
    and ``bias`` are parameters that need no gradient until a trainer asks
    for one (``requires_grad_``); the running statistics are buffers.  A
    new one is in eval mode, as every model of the port starts (serving
    builds them): only an explicit ``.train()`` switches it.

    ``group``: a process group (``sync_batch_stats``) over which train
    mode takes its statistics, as the JAX package's sharded step does: the
    mean over the global batch.  The sums of x and x^2 and the count go
    over the group in one all-reduce, whose backward all-reduces their
    gradients, so each rank's input gets the gradient through the global
    statistics once (DDP then averages the parameters' gradients, as the
    global batch's mean loss would).  None (the default): the process's
    own batch."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(num_features),
                                 requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.group = None
        self.train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train(x)
        mean, mul, bias = self.eval_terms()
        return (x - mean) * mul + bias

    def eval_terms(self):
        """Eval mode's (mean, rsqrt(var + eps) * weight, bias) as (C, 1,
        1): differentiable while a trainer asks for the weight's gradient,
        else ``_terms``'s cached ones."""
        if torch.is_grad_enabled() and self.weight.requires_grad:
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return (self.running_mean[:, None, None], mul[:, None, None],
                    self.bias[:, None, None])
        return self._terms()

    def _train(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.group is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
        else:
            mean, var = self.moments(self.partial_sums(xf))
        return self.normalise(xf, mean, self.batch_mul(mean, var)).to(
            x.dtype)

    @staticmethod
    def partial_sums(xf: torch.Tensor) -> torch.Tensor:
        """(sum of x, sum of x^2, count) of one part of the batch, over
        (N, H, W): 2C + 1 values."""
        c = xf.shape[1]
        return torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                          xf.new_full((1,), xf.numel() // c)])

    def moments(self, sums: torch.Tensor):
        """The mean and the biased variance (clipped at 0) from the
        ``partial_sums`` of the whole batch, summed over ``group`` first
        where there is one."""
        if self.group is not None:
            sums = _AllReduceSum.apply(sums, self.group)
        c = (sums.shape[0] - 1) // 2
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean,
                          min=0.0)
        return mean, var

    def batch_mul(self, mean: torch.Tensor, var: torch.Tensor
                  ) -> torch.Tensor:
        """rsqrt(var + eps) * weight of the batch's statistics; the running
        statistics move towards them, once a step (not while ``remat``
        recomputes)."""
        if not getattr(_remat, "active", False):
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        return torch.rsqrt(var + BN_EPS) * self.weight

    def normalise(self, xf: torch.Tensor, mean: torch.Tensor,
                  mul: torch.Tensor, bias: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """(x - mean) * mul + bias over the channels of NCHW ``x``;
        ``bias`` defaults to the module's."""
        bias = self.bias if bias is None else bias
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + bias[:, None, None])

    def _terms(self):
        """(mean, rsqrt(var + eps) * weight, bias) as (C, 1, 1), kept until
        a buffer is replaced or written: a detect dispatches ~100 of these
        layers, and recomputing the terms in every call made up a large
        share of the operations its host enqueues.  While a program is
        traced (``torch.export``, ``torch.compile``) the terms are computed
        in the graph, uncached: a traced tensor has no storage, so no
        ``data_ptr()`` to key on."""
        if torch.compiler.is_compiling():
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return (self.running_mean[:, None, None], mul[:, None, None],
                    self.bias[:, None, None])
        bufs = (self.weight, self.bias, self.running_mean, self.running_var)
        key = tuple((b.data_ptr(), b._version) for b in bufs)
        cached = self.__dict__.get("_cached_terms")
        if cached is None or cached[0] != key:
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            cached = (key, (self.running_mean[:, None, None],
                            mul[:, None, None], self.bias[:, None, None]))
            self.__dict__["_cached_terms"] = cached
        return cached[1]


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group, differentiable: the gradient of each
    rank's input is the sum of every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sync_batch_stats(model: nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``model`` takes its train-mode statistics over
    the process group ``group`` (None: over its own batch again)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class BatchRows(NamedTuple):
    """A dropout stream for one rank's rows of a global batch: a head draws
    the mask of all ``total`` rows from ``generator`` and keeps rows
    ``[start, start + its batch)``, so each rank drops what one process
    at the global batch drops."""
    generator: torch.Generator
    start: int
    total: int


def dropout_draw(shape, generator, device) -> torch.Tensor:
    """Uniform numbers of ``shape`` from ``generator`` (a
    ``torch.Generator``, a ``BatchRows`` or None)."""
    if isinstance(generator, BatchRows):
        full = torch.rand((generator.total,) + tuple(shape[1:]),
                          generator=generator.generator, device=device)
        return full[generator.start:generator.start + shape[0]]
    return torch.rand(shape, generator=generator, device=device)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with an optional ``norm`` applied after the convolution."""

    def __init__(self, *args, norm: Optional[nn.Module] = None, **kw):
        super().__init__(*args, **kw)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        return self.norm(x) if self.norm is not None else x


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at +-2 standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class ConvModule(nn.Module):
    """mmcv's conv -> BN -> ReLU unit with its parameter names (``conv``,
    ``bn``), so an mmseg state dict loads through ``load_state_dict``.
    As the JAX package's: ``with_norm`` / ``with_act`` drop the BN / the
    ReLU, the conv has a bias exactly when there is no BN, and ``groups``
    groups it.  ``act`` replaces the ReLU: a function (``hswish``,
    ``relu6``), or a module with parameters of its own, held under the
    name flax gives a module made inside the unit's call (its class name
    and ``_0``: CGNet's ``PReLU_0``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 with_norm: bool = True, with_act: bool = True,
                 groups: int = 1, act=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              dilation=dilation, groups=groups,
                              bias=not with_norm)
        self.bn = BatchNorm(out_channels) if with_norm else None
        self.with_act = with_act
        self.act, self.act_module = F.relu, None
        if isinstance(act, nn.Module):
            self.act_module = f"{type(act).__name__}_0"
            self.add_module(self.act_module, act)
        elif act is not None:
            self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if not self.with_act:
            return x
        if self.act_module is not None:
            return self._modules[self.act_module](x)
        return self.act(x)


def hswish(x: torch.Tensor) -> torch.Tensor:
    """x * clip(x + 3, 0, 6) / 6, as the JAX package writes it (not
    ``F.hardswish``)."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    """clip(x + 3, 0, 6) / 6, as the JAX package writes it (not
    ``F.hardsigmoid``)."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


class PReLU(nn.Module):
    """flax's ``nn.PReLU``: one 0-D ``negative_slope`` shared by every
    channel, 0.01 at init (torch's ``nn.PReLU`` holds a (1,) ``weight``
    that starts at 0.25)."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        self.negative_slope.fill_(0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


@torch.no_grad()
def init_flax_random(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers in place: lecun-normal conv and dense
    kernels, zero biases, unit batch and layer norms (weight 1, bias 0,
    mean 0, variance 1); a module with parameters of its own (a gate, a
    codebook, a basis) draws them in its ``flax_init_(generator)``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = m.weight
            fan_in = int(np.prod(w.shape[1:]))
            w.copy_(lecun_normal_(torch.empty(w.shape), fan_in, generator))
            if m.bias is not None:
                m.bias.zero_()
        elif hasattr(m, "flax_init_"):
            m.flax_init_(generator)


LN_EPS = 1e-6         # flax's nn.LayerNorm


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last axis with flax's epsilon (1e-6; torch's
    default is 1e-5)."""

    def __init__(self, features: int):
        super().__init__(features, eps=LN_EPS)


def ln_nchw(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channels of a (B, C, H, W) map (flax's over the
    last axis of an NHWC one)."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU in the form the call site names: ``approximate=True`` is
    flax's default ``nn.gelu`` (tanh), ``False`` the exact erf form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def heads_split(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H*D) -> (B, H, N, D)."""
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).transpose(1, 2)


def heads_merge(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H*D)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           divisor=None, bias=None) -> torch.Tensor:
    """softmax(q k^T / divisor + bias) v over (B, H, N, D) heads: the
    product divided by ``divisor`` where the JAX module divides it (by
    sqrt(head_dim)), or not, where it scaled the queries already."""
    attn = torch.einsum("bhnd,bhmd->bhnm", q, k)
    if divisor is not None:
        attn = attn / divisor
    if bias is not None:
        attn = attn + bias
    return torch.einsum("bhnm,bhmd->bhnd", torch.softmax(attn, dim=-1), v)


class MultiHeadAttention(nn.Module):
    """flax's ``nn.MultiHeadDotProductAttention`` (no dropout, no mask):
    ``query`` / ``key`` / ``value`` projections to heads x head_dim, each
    with a bias, the query divided by sqrt(head_dim) before its product
    with the keys, a softmax, and the ``out`` projection.  flax's
    (C, heads, head_dim) kernels are the port's (heads * head_dim, C)
    ``nn.Linear`` weights (``mmseg_import.flax_to_torch_state`` reshapes
    them)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        return self.out(self.mix(self.query(x), self.key(kv),
                                 self.value(kv)))

    def mix(self, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
        """The projected queries (B, N, C) against the projected keys and
        values (B, M, C), the heads merged: the attention before ``out``
        (a sharded forward projects each shard's tokens itself)."""
        h = self.num_heads
        q = heads_split(q, h)
        q = q / math.sqrt(q.shape[-1])
        return heads_merge(attend(q, heads_split(k, h), heads_split(v, h)))


def same_pads(size: int, kernel: int, stride: int):
    """flax's (lax's) ``"SAME"`` padding of one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """nn.Conv2d with flax ``nn.Conv``'s default ``"SAME"`` padding: the
    output has ceil(size / stride) cells a side, the padding split with
    the odd cell at the end."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph, pw = same_pads(x.shape[-2], kh, sh), same_pads(x.shape[-1], kw, sw)
        if any(ph + pw):
            x = F.pad(x, (*pw, *ph))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator,
            truncated: bool = False) -> torch.Tensor:
    """flax's ``normal(std)`` or ``truncated_normal(std)`` (cut at +-2
    standard deviations, scaled back to std) into ``t``."""
    with torch.no_grad():
        if not truncated:
            return t.normal_(0.0, std, generator=generator)
        s = std / 0.87962566103423978
        return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s,
                                     generator=generator)


class InputShaped(nn.Module):
    """The base of a module whose parameters named in ``input_shaped``
    take their shape from the input, as flax shapes a variable from the
    input it is initialised on: each is None until the first forward
    binds it (``bind``) or a loaded state dict gives it, and is held to
    that shape after; another raises ValueError, where the JAX package's
    variable would not fit.  Its random values come from a seed that
    ``flax_init_`` draws, so a seed gives the same weights whatever
    device binds them."""

    input_shaped: tuple = ()

    def __init__(self):
        super().__init__()
        for name in self.input_shaped:
            self.register_parameter(name, None)
        self.shape_seed = None

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        self.shape_seed = int(torch.randint(0, 2 ** 62, (),
                                            generator=generator))
        for name in self.input_shaped:
            self._parameters[name] = None

    def unbound(self) -> bool:
        return any(self._parameters[n] is None for n in self.input_shaped)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        for name in self.input_shaped:
            w = state_dict.get(prefix + name)
            if w is not None and self._parameters[name] is None:
                self._parameters[name] = nn.Parameter(torch.empty(
                    w.shape, dtype=w.dtype, device=w.device))
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def bind(self, name: str, shape, like: torch.Tensor, init,
             mismatch: str) -> torch.Tensor:
        """The parameter ``name``, made now of ``shape`` (on ``like``'s
        device and in its type, drawn by ``init(tensor, generator)``) if
        it is unbound; ValueError with ``mismatch`` if it was bound to
        another shape."""
        p = self._parameters[name]
        shape = tuple(shape)
        if p is None:
            g = (torch.Generator().manual_seed(self.shape_seed)
                 if self.shape_seed is not None else None)
            with torch.no_grad():
                w = init(torch.empty(shape, dtype=torch.float32), g)
            p = nn.Parameter(w.to(device=like.device, dtype=like.dtype))
            self._parameters[name] = p
        elif tuple(p.shape) != shape:
            raise ValueError(f"{mismatch}: {name} has shape "
                             f"{tuple(p.shape)}, this input needs {shape}")
        return p


def needs_binding(model: nn.Module) -> bool:
    """Whether a parameter of ``model`` waits for an input to shape it."""
    return any(isinstance(m, InputShaped) and m.unbound()
               for m in model.modules())
