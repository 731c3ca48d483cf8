"""Building blocks of the port's transformer models, with the reference's
numerics.

The reference writes its models in Flax (``cqs_tpu/models/bert.py``,
``gemma.py``): ``Dense``/``DenseGeneral`` kernels kept in f32 and cast to the
module's dtype at each use, ``LayerNorm`` statistics in f32 by the fast
variance ``E[x^2] - E[x]^2``, attention logits accumulated in f32
(``preferred_element_type``), softmax in f32 and probabilities cast back to
the module's dtype. These are the same operations in PyTorch, with the same
rounding points:

- :class:`Dense` keeps ``weight`` as ``[out, in]`` (a Flax kernel
  transposed; a ``DenseGeneral`` kernel flattened first, see
  ``models/convert.py``) in ``param_dtype`` and casts it, with the bias and
  the input, to ``dtype`` at each use, where Flax's ``promote_dtype`` does;
  :class:`Embed` casts its table before the lookup, as Flax does. Serving
  holds the parameters in the dtype it computes in (``param_dtype`` unset),
  so a bf16 layer holds bf16 weights, the value Flax's cast gives; the
  trainers hold f32 master parameters (``param_dtype=torch.float32``) and
  compute in bf16, as Flax's ``param_dtype`` f32 under ``dtype`` bf16 does:
  a bf16 parameter would lose an AdamW step of 1e-4 (bf16's relative step
  is 7.8e-3). The two give bit-equal forwards from the same parameters;
- :class:`LayerNorm` and :class:`RMSNorm` keep their weights in f32 and
  compute in f32, as Flax does under a bf16 module;
- :func:`attention` upcasts q and k to f32 (exact) and multiplies them in
  f32, so the logits are the f32 sums the reference asks for; a bf16
  ``torch.matmul`` would round them to bf16. It runs over slices of the
  batch, so that one slice's ``[b, heads, L, L]`` logits stay near
  :data:`ATTN_SLICE_BYTES`: at 512 rows of 2048 tokens the whole batch's
  logits alone would take 25.8 GB. Rows are independent, so the slicing
  changes no value.

None of this is a kernel of the port: the reference's models contain no
Pallas kernel, so their PyTorch versions are plain tensor code.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

#: the f32 logits of one attention slice stay near this size
ATTN_SLICE_BYTES = 1 << 30

#: Flax's truncated-normal initializers divide by the std of a unit normal
#: truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """Flax ``Dense`` (and ``DenseGeneral``, flattened): ``x @ W.T + b``,
    computed in ``dtype`` from parameters held in ``param_dtype`` (default:
    ``dtype``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        pd = param_dtype or dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=pd))
        self.bias = nn.Parameter(torch.empty(out_features, dtype=pd)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)

    def reset(self, gen: torch.Generator) -> None:
        """Flax's ``lecun_normal``: truncated normal, std sqrt(1 / fan_in)."""
        std = 1.0 / math.sqrt(self.weight.shape[1]) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Embed(nn.Module):
    """Flax ``Embed``: a lookup in the table cast to ``dtype``, the table
    held in ``param_dtype`` (default: ``dtype``)."""

    def __init__(self, num: int, features: int, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features, dtype=param_dtype or dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight.to(self.dtype))

    def reset(self, gen: torch.Generator) -> None:
        """Flax's default embedding init (``variance_scaling(1, "fan_in",
        "normal", out_axis=0)``, whose fan-in is the feature width): normal,
        std sqrt(1 / features)."""
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(self.weight.shape[1]), generator=gen)


class LayerNorm(nn.Module):
    """Flax ``LayerNorm``: f32 statistics by the fast variance, f32 scale
    and bias, the result cast to ``dtype``."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)

    def reset(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class RMSNorm(nn.Module):
    """The reference's ``RMSNorm`` (``gemma.py:169-182``): f32, scaled by
    ``1 + w`` (Gemma, ``w`` starts at zeros) or by ``w`` (qwen3, ones),
    cast back to the input's dtype."""

    def __init__(self, features: int, eps: float, plus_one: bool = True):
        super().__init__()
        self.eps = eps
        self.plus_one = plus_one
        self.weight = nn.Parameter(torch.empty(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        mult = (1.0 + self.weight) if self.plus_one else self.weight
        return (xf * mult).to(x.dtype)

    def reset(self, gen: torch.Generator) -> None:
        (nn.init.zeros_ if self.plus_one else nn.init.ones_)(self.weight)


def init_module(module: nn.Module, seed: int) -> nn.Module:
    """Random init of every layer above from ``seed``, on the parameters'
    device, in a fixed order. Not the reference's numbers (``jax.random``
    draws others): parity tests carry parameters across instead
    (``models/convert.py``)."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset"):
                m.reset(gen)
    return module


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Callable[[int, int], torch.Tensor], scale: float) -> torch.Tensor:
    """``softmax(q k^T * scale + bias) v`` over ``[B, L, heads, D]`` tensors
    (k and v already at q's head count), as the reference computes it:
    logits in f32 from f32 copies of q and k, ``bias(lo, hi)`` the f32
    additive bias of batch rows ``lo:hi`` (broadcastable to ``[b, heads, L,
    L]``), softmax in f32, probabilities cast to v's dtype, the context
    product in that dtype. Returns ``[B, L, heads, D]`` in v's dtype. Runs
    over slices of the batch whose logits take about
    :data:`ATTN_SLICE_BYTES`."""
    B, L, H, _ = q.shape
    per_row = H * L * k.shape[1] * 4
    step = max(1, ATTN_SLICE_BYTES // per_row)
    out = []
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        qs = q[lo:hi].float().transpose(1, 2)                 # [b, H, L, D]
        ks = k[lo:hi].float().transpose(1, 2)
        logits = torch.matmul(qs, ks.transpose(-1, -2)) * scale
        probs = torch.softmax(logits + bias(lo, hi), dim=-1).to(v.dtype)
        out.append(torch.matmul(probs, v[lo:hi].transpose(1, 2)).transpose(1, 2))
    return out[0] if len(out) == 1 else torch.cat(out)


def pad_bias(mask: torch.Tensor) -> torch.Tensor:
    """``(1 - mask) * -1e9`` as ``[B, 1, 1, L]`` f32 (keys only)."""
    return (1.0 - mask[:, None, None, :].float()) * -1e9
