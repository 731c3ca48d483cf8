"""Contrastive, distillation and cross-encoder training of the port's models,
on one device or over a (dp, tp) mesh.

Port of ``cqs_tpu/parallel/train.py`` (and of the step that
``cqs_tpu/cli/commands.py::cmd_train_reranker`` writes inline). The models
are the port's ``torch.nn`` modules (``models/bert.py``, ``hybrid.py``),
built with f32 master parameters and run in ``TrainConfig.dtype`` (bf16, the
reference's ``BertConfig.dtype`` default), cast at each use as Flax's
``param_dtype`` f32 under ``dtype`` bf16 does (``models/layers.py``). A step
is a plain function of the module: forward, loss, ``backward``, then the
optimizer, whose arithmetic is optax's, not torch's defaults:

- :class:`AdamW` is ``optax.adamw``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
  weight decay 1e-4 on every parameter (norms and biases too), the bias
  corrections in f32, ``update = -lr * (mu_hat / (sqrt(nu_hat) + eps) + wd
  * p)``; a schedule is read at the count before the step, so a warmup from
  0 makes the first update 0, as ``optax.scale_by_schedule`` does;
- :func:`clip_by_global_norm_` is ``optax.clip_by_global_norm``: the
  gradients become ``(g / norm) * max_norm`` only when the norm is not below
  ``max_norm``, with no ``+1e-6`` (``torch.nn.utils.clip_grad_norm_`` adds
  one);
- the hybrid's mixing scales take no update while ``freeze_scales`` holds:
  they are left out of the optimizer. The reference means the same, but
  masks them with ``optax.masked``, which passes a masked leaf's raw
  gradient through as its update, so its "frozen" scales step by +1 x
  gradient (``ROADMAP.md`` section 3; ``tests/test_torch_train.py``).
  As in the reference, :class:`DistillTrainer` trains every parameter, the
  scales included.

:class:`RerankerTrainer` computes in f32 on the CPU, as the reference's
cross-encoder trainer does off the TPU, and in bf16 on a GPU, the card's
counterpart of the TPU's bf16 (``cmd_train_reranker`` picks the dtype).

The in-batch score products ``q @ p.T`` are f32 matrix products of the
models' f32 unit vectors; TF32 stays off (PyTorch's default), as the
reference asks f32 sums. The contrastive and distillation trainers take a
``mesh`` (the reference's ``(dp, tp)`` mesh, ``parallel/mesh.py``): None or
a (1, 1) mesh runs the one-device step; a larger one places the parameters
and runs the forward over it in this one process
(``parallel/tensor_parallel.py``), with ``batch_per_device`` rows on each dp
row, so the global batch is ``batch_per_device * dp``, and the losses
contract the whole global batch on device (0, 0), as the reference's
cross-dp contraction does. :class:`RerankerTrainer` stays on one device, as
the reference's ``cmd_train_reranker`` does. Entry points run on ``cuda``
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.models.bert import BertConfig, BertDenseEmbedder, CrossEncoder
from cqs_tpu_torch.models.convert import flax_tree_from_torch, params_from_flax
from cqs_tpu_torch.models.hybrid import HybridConfig, HybridDenseEmbedder
from cqs_tpu_torch.models.layers import init_module
from cqs_tpu_torch.parallel.mesh import Mesh
from cqs_tpu_torch.parallel.tensor_parallel import TPGrid, to_device
from cqs_tpu_torch.utils.trace import recorder, span

#: the softmax-safe mask of the listwise loss (exp underflows cleanly in f32
#: and bf16; -1e30 squared inside backward terms overflows)
NEG = -1e9


@dataclass
class TrainConfig:
    vocab_size: int = 32768
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 8
    intermediate_size: int = 512
    seq_len: int = 64
    batch_per_device: int = 8
    lr: float = 1e-4
    temperature: float = 0.05
    family: str = "bert"         # bert | hybrid (wide-and-deep, models/hybrid.py)
    hash_dim: int = 256
    hash_seed: int = 0
    #: freeze the hybrid mixing scales at their init (1.0, 0.3): letting the
    #: optimizer grow the learned leg overfits the train pairs (r3 measured
    #: scales drifting to (0.80, 0.48) and eval R@5 LOSING to the frozen
    #: hash ordering)
    freeze_scales: bool = True
    #: the dtype the model computes in; its parameters are f32 whatever it is
    dtype: torch.dtype = torch.bfloat16

    def bert(self) -> BertConfig:
        return BertConfig(vocab_size=self.vocab_size, hidden_size=self.hidden_size,
                          num_layers=self.num_layers, num_heads=self.num_heads,
                          intermediate_size=self.intermediate_size,
                          max_position=self.seq_len, dtype=self.dtype,
                          param_dtype=torch.float32)


def build_model(cfg: TrainConfig, device: torch.device, seed: int) -> torch.nn.Module:
    """The dual encoder of ``cfg.family`` on ``device``, mean-pooled, its
    parameters f32 and initialized from ``seed`` with Flax's distributions
    (``models/layers.py::init_module``)."""
    bcfg = cfg.bert()
    with torch.device(device):
        if cfg.family == "hybrid":
            model = HybridDenseEmbedder(HybridConfig(bert=bcfg, hash_dim=cfg.hash_dim,
                                                     hash_seed=cfg.hash_seed, pooling="mean"))
        else:
            model = BertDenseEmbedder(bcfg, pooling="mean")
    return init_module(model, seed).train()


def by_device(tensors: list[torch.Tensor]) -> list[list[int]]:
    """The positions of ``tensors`` grouped by device, in order of first
    appearance: ``torch._foreach_*`` ops and ``torch.stack`` take one
    device's tensors at a time."""
    groups: dict[torch.device, list[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return list(groups.values())


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of squares of every
    element, as a 0-d f32 tensor on the first tensor's device. Over several
    devices each device's sum of squares is added there; every tensor (a
    shard, or a parameter held once) counts once."""
    groups = by_device(tensors)
    if len(groups) == 1:
        return torch.stack(torch._foreach_norm(tensors)).square().sum().sqrt()
    first = tensors[0].device
    sums = [torch.stack(torch._foreach_norm([tensors[i] for i in g])).square().sum().to(first)
            for g in groups]
    return torch.stack(sums).sum().sqrt()


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> float:
    """``optax.clip_by_global_norm`` in place: every gradient becomes ``(g /
    norm) * max_norm`` unless ``norm < max_norm``. Returns the norm (read on
    the host: one wait for the device a step)."""
    norm = float(global_norm(grads))
    if not norm < max_norm:
        for g in by_device(grads):
            part = [grads[i] for i in g]
            torch._foreach_div_(part, norm)
            torch._foreach_mul_(part, max_norm)
    return norm


def warmup_cosine(peak: float, warmup_steps: int, decay_steps: int,
                  init: float = 0.0, end: float = 0.0):
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup_steps,
    decay_steps, end)``: a linear warmup from ``init`` to ``peak``, then a
    cosine decay to ``end`` over ``decay_steps - warmup_steps``; a function
    of the update count (0 for the first update)."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init - peak) * frac + peak
        c = min(count - warmup_steps, span)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / span)) + alpha)

    return schedule


class AdamW:
    """``optax.adamw(lr)`` over ``params`` (after
    ``optax.clip_by_global_norm(clip_norm)`` when one is given), on the
    parameters' ``grad``, which a step consumes (sets to None). ``lr`` is a
    number or a schedule of the update count. Moments and updates are in the
    parameters' dtype (f32), each beside its parameter; parameters on
    several devices update one device's at a time."""

    def __init__(self, params, lr, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 clip_norm: float | None = None):
        self.params = list(params)
        self.lr = lr
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self._groups = by_device(self.params)

    @torch.no_grad()
    def step(self) -> None:
        # a parameter the loss did not reach has a zero gradient (optax's)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.clip_norm is not None:
            clip_by_global_norm_(grads, self.clip_norm)
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        # bias corrections in f32, as optax computes 1 - decay**count
        one, t = np.float32(1.0), np.float32(self.count)
        bc1 = float(one - np.float32(self.b1) ** t)
        bc2 = float(one - np.float32(self.b2) ** t)
        for g in self._groups:
            self._update(*([x[i] for i in g] for x in (self.params, grads, self.mu, self.nu)),
                         lr, bc1, bc2)
        for p in self.params:
            p.grad = None

    def _update(self, params, grads, mu, nu, lr: float, bc1: float, bc2: float) -> None:
        """One device's update, in place."""
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(params, self.wd))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)


def training_device(device, mesh: Mesh | None) -> torch.device:
    """The device a trainer's loss runs on: ``device`` (default ``cuda``)
    without a mesh, else the mesh's device (0, 0), after checking that the
    mesh is a (dp, tp) grid of devices that exist and that ``device``, if
    given, is that one."""
    if mesh is None:
        return resolve_device(device or "cuda")
    if tuple(mesh.shape) != ("dp", "tp"):
        raise ValueError(f"a training mesh has axes ('dp', 'tp'), not {tuple(mesh.shape)}")
    first = [resolve_device(d) for d in mesh.devices][0]
    if device is not None and resolve_device(device) != first:
        raise ValueError(f"device {device} is not the mesh's first device {first}")
    return first


class ContrastiveTrainer:
    """InfoNCE (in-batch negatives, optional mined hard negatives) on one
    device, or over a (dp, tp) ``mesh`` (``parallel/tensor_parallel.py``):
    the same initial parameters, cut into shards, and the in-batch
    contraction over the whole global batch."""

    def __init__(self, cfg: TrainConfig | None = None, seed: int = 0, *,
                 device: str | torch.device | None = None, mesh: Mesh | None = None):
        self.cfg = cfg or TrainConfig()
        self.device = training_device(device, mesh)
        self.mesh = mesh
        self.model = build_model(self.cfg, self.device, seed)
        #: the parameters placed over the mesh; None on one device (a (1, 1)
        #: mesh too), where the module itself runs
        self.grid = TPGrid(self.model, mesh) if mesh is not None and mesh.size > 1 else None
        frozen = self.cfg.family == "hybrid" and self.cfg.freeze_scales
        if frozen:
            self.model.scales.requires_grad_(False)
        #: a new AdamW has fresh state (the fine-tune stage's ``adamw(ft_lr)``)
        self.opt = AdamW(self.trainable(), self.cfg.lr)

    @property
    def global_batch(self) -> int:
        """``batch_per_device`` rows on each dp row of the mesh."""
        return self.cfg.batch_per_device * (self.mesh.shape["dp"] if self.mesh else 1)

    def trainable(self) -> list[torch.nn.Parameter]:
        params = self.model.parameters() if self.grid is None else self.grid.parameters()
        return [p for p in params if p.requires_grad]

    def embed(self, ids, mask) -> torch.Tensor:
        """The model's f32 unit vectors of host ``[B, L]`` ids and mask, on
        the trainer's device (on a grid, the rows over dp, gathered)."""
        rec = recorder()
        if rec is not None:
            rec.count("train.positions", int(np.size(mask)))
            rec.count("train.real_positions", int(np.sum(mask)))
        if self.grid is not None:
            return self.grid.embed(ids, mask)
        return self.model(to_device(ids, self.device).long(),
                          to_device(mask, self.device)).float()

    @torch.no_grad()
    def encode(self, ids, mask) -> np.ndarray:
        """``embed`` without gradients, as host numpy (the probes)."""
        return self.embed(ids, mask).cpu().numpy()

    def loss(self, q_ids, q_mask, p_ids, p_mask, n_ids=None, n_mask=None):
        """(loss, acc) as device scalars; ``n_ids``/``n_mask`` ``[B, K, L]``
        add K mined negatives a pair as extra softmax columns."""
        temp = self.cfg.temperature
        q = self.embed(q_ids, q_mask)                           # [B, D] unit
        p = self.embed(p_ids, p_mask)
        logits = (q @ p.T) / temp
        if n_ids is not None:
            L = n_ids.shape[-1]
            nneg = self.embed(np.reshape(n_ids, (-1, L)), np.reshape(n_mask, (-1, L)))
            logits = torch.cat([logits, (q @ nneg.T) / temp], dim=1)
        labels = torch.arange(logits.shape[0], device=self.device)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(dim=1) == labels).float().mean()
        return loss, acc

    def _step(self, loss_fn, *batch) -> tuple[float, float]:
        with span("train_step"):
            with span("train_forward"):
                loss, metric = loss_fn(*batch)
            with span("train_backward"):
                loss.backward()
            with span("train_optimizer"):
                self.opt.step()
            # the host waits here for the device to finish the step
            with span("train_loss_read"):
                return float(loss.detach()), float(metric)

    def train_step(self, q_ids, q_mask, p_ids, p_mask, n_ids=None, n_mask=None
                   ) -> tuple[float, float]:
        return self._step(self.loss, q_ids, q_mask, p_ids, p_mask, n_ids, n_mask)

    def jitted_step(self):
        """(fn, example_args), as the reference's ``jitted_step``: a call
        ``fn(*example_args)`` runs one in-batch step on a global batch drawn
        from ``np.random.default_rng(0)`` and returns (the trainable
        parameters, the optimizer, loss, acc), the loss and acc as device
        scalars. Nothing is compiled: the step runs eagerly."""
        c = self.cfg
        rng = np.random.default_rng(0)
        ids = rng.integers(4, c.vocab_size, size=(self.global_batch, c.seq_len)).astype(np.int32)
        mask = np.ones_like(ids)

        def step(q_ids, q_mask, p_ids, p_mask):
            loss, acc = self.loss(q_ids, q_mask, p_ids, p_mask)
            loss.backward()
            self.opt.step()
            return self.trainable(), self.opt, loss.detach(), acc

        return step, (ids, mask, ids, mask)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The whole model's ``state_dict`` (a grid's shards gathered)."""
        return self.model.state_dict() if self.grid is None else self.grid.state_dict()

    def params_tree(self) -> dict:
        """The parameters as the reference's Flax tree of numpy arrays
        (``params.pkl``, the native checkpoint), the same on a grid."""
        return flax_tree_from_torch(self.state_dict(), self.cfg.bert())

    def load_params_tree(self, tree) -> None:
        """Parameters from a Flax tree (either package's ``params.pkl``),
        cut into the grid's shards on a grid."""
        if self.grid is not None:
            self.grid.load_state_dict(params_from_flax(tree))
            return
        with torch.no_grad():
            self.model.load_state_dict(params_from_flax(tree))


def make_pair_batch(texts_q: list[str], texts_p: list[str], tokenizer, seq_len: int):
    """Tokenize (query, positive) training pairs into fixed arrays."""
    q = [tokenizer.encode(t, seq_len) for t in texts_q]
    p = [tokenizer.encode(t, seq_len) for t in texts_p]
    return (np.stack([e.ids for e in q]), np.stack([e.mask for e in q]),
            np.stack([e.ids for e in p]), np.stack([e.mask for e in p]))


def listwise_kl(q: torch.Tensor, d_flat: torch.Tensor, t_scores: torch.Tensor,
                valid: torch.Tensor, ts: float, tt: float):
    """The reference's listwise distillation loss (``train.py:226-273``):
    KL(softmax(teacher / tt) || log_softmax(student / ts)) with the student's
    softmax over all B*K documents (the other queries' candidates are
    in-batch negatives) and the teacher's mass on the query's own block;
    padded lanes masked with :data:`NEG`. Returns (mean KL, top-1 agreement
    within the own block), ties to the lower index."""
    B, K = valid.shape
    s_full = (q @ d_flat.T) / ts                                  # [B, B*K]
    live = valid.reshape(1, B * K) > 0
    s_full = torch.where(live, s_full, NEG)
    owner = torch.arange(B, device=q.device).repeat_interleave(K)
    own = (torch.arange(B, device=q.device)[:, None] == owner[None, :]) & live
    t = torch.where(valid > 0, torch.clamp(t_scores, -100.0, 100.0) / tt, NEG)
    p_own = torch.softmax(t, dim=-1)                               # [B, K]
    p_t = torch.where(own, p_own.reshape(1, B * K), 0.0)
    log_p_s = torch.log_softmax(s_full, dim=-1)
    kl = torch.where(p_t > 0, p_t * (torch.log(torch.clamp(p_t, min=1e-9)) - log_p_s),
                     0.0).sum(dim=-1)
    s_own = torch.einsum("bh,bkh->bk", q, d_flat.reshape(B, K, -1)) / ts
    s_own = torch.where(valid > 0, s_own, NEG)
    agree = (s_own.argmax(dim=-1) == t.argmax(dim=-1)).float().mean()
    return kl.mean(), agree


class DistillTrainer(ContrastiveTrainer):
    """Listwise distillation of the fused production ordering: each example
    is (query, K candidate chunks, teacher scores); the student minimizes
    :func:`listwise_kl`. Every parameter trains (the hybrid's scales too),
    behind ``clip_by_global_norm(1.0)``: the masked softmax gives occasional
    large gradients. On a grid, ``d_ids`` splits over dp with the queries
    (row r takes their candidates), and the teacher scores and lanes go whole
    to device (0, 0), where :func:`listwise_kl` runs over all B*K documents
    of the global batch."""

    def __init__(self, cfg: TrainConfig | None = None, seed: int = 0,
                 teacher_temp: float = 0.05, *, device: str | torch.device | None = None,
                 mesh: Mesh | None = None):
        self.teacher_temp = teacher_temp
        super().__init__(cfg, seed, device=device, mesh=mesh)
        for p in self.model.parameters():
            p.requires_grad_(True)
        self.opt = AdamW(self.trainable(), self.cfg.lr, clip_norm=1.0)

    def distill_loss(self, q_ids, q_mask, d_ids, d_mask, t_scores, valid):
        B, K, L = d_ids.shape
        q = self.embed(q_ids, q_mask)
        d_flat = self.embed(np.reshape(d_ids, (B * K, L)), np.reshape(d_mask, (B * K, L)))
        return listwise_kl(q, d_flat, to_device(np.asarray(t_scores, np.float32), self.device),
                           to_device(np.asarray(valid, np.int32), self.device),
                           self.cfg.temperature, self.teacher_temp)

    def distill_step(self, q_ids, q_mask, d_ids, d_mask, t_scores, valid
                     ) -> tuple[float, float]:
        return self._step(self.distill_loss, q_ids, q_mask, d_ids, d_mask, t_scores, valid)


class RerankerTrainer:
    """Pairwise cross-encoder training (``cmd_train_reranker``'s step):
    ``softplus(s_neg - s_pos)``, ``clip_by_global_norm(1.0)`` then AdamW on
    the warmup-cosine schedule from 0 to ``lr`` (warmup ``max(10, steps //
    10)``, decay ``max(steps, 20)``). ``cfg.dtype`` is the compute dtype; the
    parameters are f32."""

    def __init__(self, cfg: BertConfig, steps: int, lr: float = 5e-4, seed: int = 0, *,
                 device: str | torch.device = "cuda"):
        self.cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
        self.device = resolve_device(device)
        with torch.device(self.device):
            model = CrossEncoder(self.cfg)
        self.model = init_module(model, seed).train()
        self.sched = warmup_cosine(lr, max(10, steps // 10), max(steps, 20))
        self.opt = AdamW(self.model.parameters(), self.sched, clip_norm=1.0)

    def score(self, ids, mask, types) -> torch.Tensor:
        return self.model(to_device(ids, self.device).long(), to_device(mask, self.device),
                          to_device(types, self.device).long()).float()

    def loss(self, pi, pm, pt, ni, nm, nt):
        sp = self.score(pi, pm, pt)
        sn = self.score(ni, nm, nt)
        diff = sn - sp
        loss = torch.logaddexp(diff, torch.zeros_like(diff)).mean()      # softplus
        return loss, (sp > sn).float().mean()

    def train_step(self, pi, pm, pt, ni, nm, nt) -> tuple[float, float]:
        loss, acc = self.loss(pi, pm, pt, ni, nm, nt)
        loss.backward()
        self.opt.step()
        return float(loss.detach()), float(acc)

    def params_tree(self) -> dict:
        return flax_tree_from_torch(self.model.state_dict(), self.cfg)

    def load_params_tree(self, tree) -> None:
        with torch.no_grad():
            self.model.load_state_dict(params_from_flax(tree))
