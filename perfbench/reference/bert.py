"""The plain reference of the BERT configurations: the encoder of Hugging
Face's ``BertModel`` (post-LayerNorm, exact-erf GeLU, absolute positions,
token type 0) over tensors in the published key layout, CLS or mean
pooling and an L2 norm; the contrastive loss with hard negatives; optax's
AdamW. Plain ``torch`` operations, computed in float32 with TF32 off. It
imports nothing of the program.

``precision`` names the type the model computes in: ``f32`` (the
reference), ``bf16`` (as the port computes the BERT family on a GPU), or
``fp8`` (float8 e4m3 values and e5m2 gradients, one scale a tensor: the
control of a bf16 configuration).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``, back in f32; to a float8 type with one
    scale, which puts its largest magnitude at the type's largest value."""
    if dtype.itemsize > 1:
        return x.to(dtype).float()
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _Round(torch.autograd.Function):
    """A value rounded to ``fwd`` and its gradient to ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _quantize(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, ctx.bwd), None, None


#: the types a precision rounds values and their gradients to
PRECISIONS = {"bf16": (torch.bfloat16, torch.bfloat16),
              "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


def rounding(precision: str):
    """The rounding of ``precision`` (a function of a tensor): none for
    ``f32``; else values to the first type of :data:`PRECISIONS` and their
    gradients to the second."""
    if precision == "f32":
        return lambda x: x
    fwd, bwd = PRECISIONS[precision]
    return lambda x: _Round.apply(x, fwd, bwd)


def _linear(p: dict, key: str, x: torch.Tensor, r) -> torch.Tensor:
    return r(x @ r(p[key + ".weight"].float()).T + r(p[key + ".bias"].float()))


def _layer_norm(p: dict, key: str, x: torch.Tensor, eps: float, r) -> torch.Tensor:
    return r(F.layer_norm(x, x.shape[-1:], p[key + ".weight"].float(), p[key + ".bias"].float(),
                          eps))


def hidden_states(p: dict, c: dict, ids: torch.Tensor, mask: torch.Tensor,
                  precision: str = "f32") -> torch.Tensor:
    """The last layer's hidden states ``[B, L, H]`` in f32. Under a
    ``precision`` other than f32, every value a layer hands on (embeddings
    and their sums, linear outputs, norms, GeLU, attention probabilities and
    context, residual sums) is rounded to it, as a model computing in that
    type does; matrix products sum in f32, norms, softmax and logits are
    f32."""
    r = rounding(precision)
    eps = float(c["layer_norm_eps"])
    H, heads = c["hidden_size"], c["num_attention_heads"]
    d = H // heads
    B, L = ids.shape
    pos = torch.arange(L, device=ids.device)
    x = r(r(p["embeddings.word_embeddings.weight"].float())[ids]
          + r(p["embeddings.position_embeddings.weight"].float())[pos][None])
    x = r(x + r(p["embeddings.token_type_embeddings.weight"].float())[0])
    x = _layer_norm(p, "embeddings.LayerNorm", x, eps, r)
    bias = torch.zeros(B, 1, 1, L, device=ids.device)
    bias = bias.masked_fill(mask[:, None, None, :] == 0, torch.finfo(torch.float32).min)
    for i in range(c["num_hidden_layers"]):
        b = f"encoder.layer.{i}."

        def heads_of(t):
            return t.view(B, L, heads, d).transpose(1, 2)
        q = heads_of(_linear(p, b + "attention.self.query", x, r))
        k = heads_of(_linear(p, b + "attention.self.key", x, r))
        v = heads_of(_linear(p, b + "attention.self.value", x, r))
        probs = r(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d) + bias, dim=-1))
        ctx = r(probs @ v).transpose(1, 2).reshape(B, L, H)
        x = _layer_norm(p, b + "attention.output.LayerNorm",
                        r(x + _linear(p, b + "attention.output.dense", ctx, r)), eps, r)
        ff = _linear(p, b + "output.dense", r(F.gelu(_linear(p, b + "intermediate.dense", x, r))), r)
        x = _layer_norm(p, b + "output.LayerNorm", r(x + ff), eps, r)
    return x


def pool(h: torch.Tensor, mask: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "cls":
        v = h[:, 0]
    elif mode == "mean":
        m = mask[..., None].float()
        v = (h * m).sum(1) / m.sum(1).clamp(min=1.0)
    else:
        raise ValueError(f"unknown pooling {mode!r}")
    return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def embed(p: dict, c: dict, ids: torch.Tensor, mask: torch.Tensor, pooling: str,
          precision: str = "f32") -> torch.Tensor:
    """Unit vectors ``[B, H]`` in f32."""
    return pool(hidden_states(p, c, ids, mask, precision), mask, pooling)


def contrastive_loss(p: dict, c: dict, batch: dict, temperature: float, pooling: str,
                     precision: str = "f32", rows: slice | None = None) -> torch.Tensor:
    """InfoNCE of queries against their positives, the other positives of
    the batch and every row's hard negatives: cross entropy over ``[q.p^T |
    q.n^T] / temperature`` with the own positive as the label. ``rows``
    keeps a part of the batch (a fault the checks must catch)."""
    sel = rows or slice(None)
    q = embed(p, c, batch["q_ids"][sel], batch["q_mask"][sel], pooling, precision)
    d = embed(p, c, batch["p_ids"][sel], batch["p_mask"][sel], pooling, precision)
    n_ids, n_mask = batch["n_ids"][sel], batch["n_mask"][sel]
    n = embed(p, c, n_ids.reshape(-1, n_ids.shape[-1]), n_mask.reshape(-1, n_ids.shape[-1]),
              pooling, precision)
    logits = torch.cat([q @ d.T, q @ n.T], dim=1) / temperature
    return F.cross_entropy(logits, torch.arange(q.shape[0], device=q.device))


class AdamW:
    """``optax.adamw``: b1 0.9, b2 0.999, eps 1e-8, weight decay on every
    tensor, bias corrections in f32, ``p -= lr * (m_hat / (sqrt(v_hat) +
    eps) + wd * p)``."""

    def __init__(self, params: dict, lr: float, wd: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.p, self.lr, self.wd, self.b1, self.b2, self.eps = params, lr, wd, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            upd = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * upd)


def train_steps(p0: dict, c: dict, batches: list[dict], lr: float, temperature: float,
                pooling: str, precision: str = "f32", rows: slice | None = None,
                state: tuple | None = None) -> dict:
    """Contrastive steps from ``p0`` (left as it is) over ``batches``: each
    step's loss, every tensor's gradient at the first step, and every
    tensor's change after the last step, by key (on the host). ``state``,
    ``(m, v, t)``, is AdamW's state to start from: the moments by key and
    the number of steps taken (default: none taken)."""
    p = {k: v.detach().float().clone() for k, v in p0.items()}
    opt = AdamW(p, lr)
    if state is not None:
        m, v, opt.t = state
        opt.m = {k: m[k].to(p[k].device).float().clone() for k in p}
        opt.v = {k: v[k].to(p[k].device).float().clone() for k in p}
    losses, first = [], {}
    for i, batch in enumerate(batches):
        for v in p.values():
            v.requires_grad_(True)
        loss = contrastive_loss(p, c, batch, temperature, pooling, precision, rows)
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(p.items(), grads)}
        for v in p.values():
            v.requires_grad_(False)
        losses.append(float(loss.detach()))
        if i == 0:
            first = {k: g.cpu() for k, g in grads.items()}
        opt.step(grads)
    return {"losses": losses, "grads": first,
            "deltas": {k: (p[k] - p0[k].float()).cpu() for k in p}}
