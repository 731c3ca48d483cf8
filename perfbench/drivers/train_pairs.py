"""Driver ``train_pairs``: contrastive fine-tuning as the port's ``train``
command runs it.

Set-up draws the configuration's weights on the device from the seed (f32,
the trainer's master type), writes them as a Hugging Face checkpoint into
``TMPDIR``, builds one ``ContrastiveTrainer`` on a (1, 1) mesh and loads the
checkpoint into it through the port's loader. It then drives that trainer
through the first ``check_steps`` steps with the window's own feed, reading
each step's loss, every parameter's first gradient (from AdamW's first
moment after one step) and every parameter's change after the last of them.
The window goes on with the same trainer. A step, timed from drawing its
batch to the loss on the host, draws fresh pairs, tokenizes them on the host
as ``cmd_train``'s ``run_stage`` does, and calls ``train_step``. Shortly
before the window closes (about ``window_check_steps`` steps before, by the
recent steps' time), the parameters and AdamW's moments are copied on the
device; the steps from there to the close are read for the check too.

The check, once the window has closed and the trainer is freed: the
reference's f32 steps over the same texts, from the same weights for the
first steps and from the copied state for the window's last, compared by the
loss of each step and by the median parameter's gap in the norm of its first
gradient (first steps) and of its change (both).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from perfbench import flops
from perfbench.core import Outcome, sync
from perfbench.gen.pairs import PairGenerator
from perfbench.reference import bert as ref
from perfbench.reference import tokenizer as rtok
from perfbench.trace import Spans, device_window, gemm_seconds
from perfbench.weights import DTYPES, draw_bert, write_checkpoint


def _leaf_names(model, drawn: dict) -> dict[int, str]:
    """The published key of each trainable parameter, found by its loaded
    value (``id(parameter) -> key``); every parameter must have one."""
    index: dict[tuple, list[str]] = {}
    for k, v in drawn.items():
        index.setdefault((tuple(v.shape), float(v.reshape(-1)[0])), []).append(k)
    out = {}
    for name, p in model.named_parameters():
        keys = [k for k in index.get((tuple(p.shape), float(p.detach().reshape(-1)[0])), [])
                if torch.equal(drawn[k], p.detach())]
        if len(keys) != 1:
            raise RuntimeError(f"parameter {name} matches {len(keys)} drawn tensors")
        out[id(p)] = keys[0]
    return out


def _snapshot(trainer) -> tuple:
    """The trainer's parameters, AdamW's moments and step count, copied on
    the device."""
    with torch.no_grad():
        opt = trainer.opt
        return ([p.detach().clone() for p in opt.params], [m.clone() for m in opt.mu],
                [v.clone() for v in opt.nu], opt.count)


def run(cell) -> Outcome:
    c, t, dev = cell.config, cell.traffic, cell.device
    from cqs_tpu_torch.models.loader import load_safetensors_params
    from cqs_tpu_torch.models.tokenizer import load_tokenizer
    from cqs_tpu_torch.parallel import ContrastiveTrainer, TrainConfig, make_2d_mesh
    from cqs_tpu_torch.parallel.train import make_pair_batch

    B, K, L = int(t["batch"]), int(t["negatives"]), int(t["seq_len"])
    work = cell.workdir()
    with cell.step("draw weights on the device"):
        drawn = draw_bert(c, cell.seed, dev, torch.float32)
        sync(dev)
    with cell.step("write the checkpoint"):
        ckpt = write_checkpoint(work / "checkpoint", c, drawn)
    with cell.step("build the trainer and load the checkpoint"):
        # the trainer's position table has ``seq_len`` rows: the published
        # table whole; the feed's sequences are ``L`` tokens
        cfg = TrainConfig(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                          num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
                          intermediate_size=c["intermediate_size"],
                          seq_len=int(c["max_position_embeddings"]),
                          batch_per_device=B, lr=float(t["lr"]),
                          temperature=float(t["temperature"]), dtype=DTYPES[c["compute_dtype"]])
        trainer = ContrastiveTrainer(cfg, seed=cell.seed, mesh=make_2d_mesh(1, device=dev))
        loaded = load_safetensors_params(ckpt, trainer.model.state_dict(), "bert")
        trainer.model.load_state_dict(loaded)
        names = _leaf_names(trainer.model, drawn)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        if "unchanged" in cell.faults:
            trainer.opt.step = lambda: [setattr(p, "grad", None) for p in trainer.opt.params]
        if "half_batch" in cell.faults:
            inner = trainer.loss
            trainer.loss = lambda qi, qm, pi, pm, ni, nm: inner(
                qi[:B // 2], qm[:B // 2], pi[:B // 2], pm[:B // 2], ni[:B // 2], nm[:B // 2])
    tok = load_tokenizer(None, vocab_size=c["vocab_size"])
    gen = PairGenerator(t, cell.seed)
    qp, dp = t["query_prefix"], t["doc_prefix"]
    spans = Spans()
    steps_ms: list[float] = []
    losses: list[float] = []
    real_flops = 0.0

    def step(i: int):
        nonlocal real_flops
        t0 = time.perf_counter()
        with spans("host_prep"):
            queries, positives, negatives = gen.step(i)
            batch = make_pair_batch([qp + q for q in queries], [dp + p for p in positives], tok, L)
            encs = [tok.encode(dp + n, L) for n in negatives]
            n_ids = np.stack([e.ids for e in encs]).reshape(B, K, -1)
            n_mask = np.stack([e.mask for e in encs]).reshape(B, K, -1)
            if "token" in cell.faults:
                for ids in (batch[0], batch[2], n_ids.reshape(-1, L)):
                    ids[:, 1] = 4 + (ids[:, 1] - 3) % (c["vocab_size"] - 4)
        with spans("step"):
            loss, _ = trainer.train_step(*batch, n_ids, n_mask)
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        real = np.concatenate([batch[1].sum(1), batch[3].sum(1), n_mask.reshape(-1, L).sum(1)])
        real_flops += flops.train_flops(c, real.tolist())
        return queries, positives, negatives

    n_check = int(t["check_steps"])
    texts = []
    with cell.step(f"first {n_check} steps, read for the check"):
        for i in range(n_check):
            texts.append(step(i))
            if i == 0:
                b1 = trainer.opt.b1
                grads = {names[id(p)]: (m / (1 - b1)).cpu()
                         for p, m in zip(trainer.opt.params, trainer.opt.mu)}
        deltas = {names[id(p)]: (p.detach() - drawn[names[id(p)]]).cpu()
                  for p in trainer.model.parameters()}
        drawn = {k: v.cpu() for k, v in drawn.items()}
        sync(dev)
    check_losses = list(losses)
    steps_ms.clear()
    real_flops = 0.0
    spans.seconds.clear()
    spans.count.clear()
    setup_s = time.perf_counter() - cell.t0
    cell.log(f"set-up done: {setup_s:.3f} s; window of {cell.seconds} s")
    n_win = int(t["window_check_steps"])
    snap, after = None, []
    w0 = time.perf_counter()
    i = n_check
    while (now := time.perf_counter() - w0) < cell.seconds:
        if steps_ms and (snap is None or len(after) >= 2 * n_win) and \
                cell.seconds - now < (n_win + 0.5) * float(np.mean(steps_ms[-20:])) / 1e3:
            snap, after = _snapshot(trainer), []
        texts_i = step(i)
        if snap is not None:
            after.append(texts_i)
        i += 1
    window_s = time.perf_counter() - w0
    n_steps = i - n_check
    if not after:
        # a window too short to see its end coming: the steps right after it
        snap = _snapshot(trainer)
        after = [step(i + k) for k in range(n_win)]
        i += n_win
    window_losses = losses[-len(after):]
    key_of = [names[id(p)] for p in trainer.opt.params]
    window_post = {k: p.detach().to("cpu", copy=True) for k, p in zip(key_of, trainer.opt.params)}
    snap = tuple({k: x.cpu() for k, x in zip(key_of, xs)} for xs in snap[:3]) + (snap[3],)
    p95 = float(np.percentile(steps_ms, 95))
    cell.log(f"window: {n_steps} steps, {window_s:.3f} s; step ms quartiles "
             f"{np.percentile(steps_ms, [25, 50, 75, 95]).round(2).tolist()}")
    record = {"cell": "train", "window_s": window_s, "steps": n_steps, "pairs": n_steps * B,
              "real_flops": real_flops,
              "host_prep_s": spans.seconds["host_prep"], "step_s": spans.seconds["step"]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if cell.trace:
        n_trace = int(t["traced_steps"])
        with cell.step("trace the matrix products of 2 steps"):
            gemm_s = gemm_seconds(lambda: [step(i + k) for k in range(2)], lambda: sync(dev))
        with cell.step(f"trace the device over {n_trace} steps"):
            trace = device_window(lambda: [step(i + 2 + k) for k in range(n_trace)], spans,
                                  lambda: sync(dev))
        trace.update(gemm_s=gemm_s, gemm_flops=3 * flops.dense_flops(c, 2 * B * (K + 2) * L))
        record["trace"] = trace
    nonfinite = sum(not math.isfinite(x) for x in losses)
    del trainer, loaded
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with cell.step("check against the reference"):
        got = {"losses": check_losses, "grads": grads, "deltas": deltas}
        want = reference_steps(cell, drawn, texts)
        mine = readings(got, want)
        start, state = snap[0], snap[1:]
        got_w = {"losses": window_losses,
                 "deltas": {k: window_post[k] - start[k] for k in window_post}}
        want_w = reference_steps(cell, start, after, state=state)
        mine.update(window_readings(got_w, want_w))
        checks = {k: (mine[k], lim) for k, lim in cell.limits.items() if k in mine}
        cell.log(f"readings: {mine}")
        cell.log(f"losses (program, reference): {got['losses']} {want['losses']}; window's last "
                 f"{len(after)} from step {snap[3]}: {got_w['losses']} {want_w['losses']}")
        checks["nonfinite"] = (nonfinite, cell.limits["nonfinite"])
        if cell.control:
            record["control"] = control_readings(cell, drawn, texts, want)
            for name, r in control_readings(cell, start, after, want_w, state).items():
                record["control"][name].update(window_readings(None, want_w, r))
    e2e = {"train_pairs_per_s": (n_steps * B / window_s, "pairs/s"),
           "train_step_p95_ms": (p95, "ms"), "setup_s": (setup_s, "s")}
    return Outcome(attempted=n_steps, failed=nonfinite, e2e=e2e, record=record, checks=checks,
                   memory_peak_bytes=peak, trace=trace)


def reference_batches(cell, texts) -> list[dict]:
    """The steps' texts tokenized by the reference's tokenizer, on the
    cell's device."""
    c, t, dev = cell.config, cell.traffic, cell.device
    L, vocab = int(t["seq_len"]), c["vocab_size"]
    out = []
    for queries, positives, negatives in texts:
        b = {}
        for key, items, prefix in (("q", queries, t["query_prefix"]), ("p", positives, t["doc_prefix"]),
                                   ("n", negatives, t["doc_prefix"])):
            ids, mask = rtok.encode_batch([prefix + x for x in items], vocab, L, L)
            if key == "n":
                ids, mask = ids.reshape(len(queries), -1, L), mask.reshape(len(queries), -1, L)
            b[key + "_ids"] = torch.from_numpy(ids).to(dev)
            b[key + "_mask"] = torch.from_numpy(mask).to(dev)
        out.append(b)
    return out


def reference_steps(cell, drawn: dict, texts, precision: str = "f32",
                    rows: slice | None = None, state: tuple | None = None) -> dict:
    ref.tf32_off()
    t = cell.traffic
    drawn = {k: v.to(cell.device) for k, v in drawn.items()}
    return ref.train_steps(drawn, cell.config, reference_batches(cell, texts), float(t["lr"]),
                           float(t["temperature"]), "mean", precision, rows, state)


def control_readings(cell, drawn: dict, texts, want: dict, state: tuple | None = None) -> dict:
    """The numbers of :func:`readings` (with ``state``: the reference's
    steps themselves, for :func:`window_readings`), read off the reference
    put in the program's place: in bf16 and in fp8 (the control), over half
    of each batch, and with every sequence's first token altered."""
    B = int(cell.traffic["batch"])
    out = {}
    for name, kw, tx in (("bf16", {"precision": "bf16"}, texts),
                         ("fp8", {"precision": "fp8"}, texts),
                         ("half_batch", {"rows": slice(0, B // 2)}, texts),
                         ("token", {}, [tuple([_alter(x) for x in part] for part in step)
                                        for step in texts])):
        r = reference_steps(cell, drawn, tx, state=state, **kw)
        out[name] = r if state is not None else readings(r, want)
    return out


def _alter(text: str) -> str:
    """The text with its first word replaced: another first token in every
    sequence the feed produces."""
    head, _, rest = text.partition(" ")
    return "zz" + head + (" " + rest if rest else "")


def _leaf_gaps(a: dict, b: dict, leaves: list[str]) -> tuple[list[float], list[float]]:
    """Each leaf's gap of norms and norm of the difference, against the
    larger of the reference's norm of that leaf and of the median leaf."""
    ref_norm = {k: float(b[k].norm()) for k in leaves}
    med = float(np.median(list(ref_norm.values())))
    gap = [abs(float(a[k].norm()) - ref_norm[k]) / max(ref_norm[k], med) for k in leaves]
    diff = [float((a[k] - b[k]).norm()) / max(ref_norm[k], med) for k in leaves]
    return gap, diff


def _moved(want: dict) -> list[str]:
    """Leaves whose reference gradient is at least a thousandth of the median
    leaf's: the others move by rounding alone."""
    g_norm = {k: float(v.norm()) for k, v in want["grads"].items()}
    g_med = float(np.median(list(g_norm.values())))
    return sorted(k for k in g_norm if g_norm[k] >= 1e-3 * g_med)


def window_readings(got: dict | None, want: dict, control: dict | None = None) -> dict:
    """The numbers of the window's last steps, from the state copied before
    them: ``window_loss_gap``, the largest relative gap of a step's loss,
    and ``window_delta_gap_med``, the median moved leaf's gap in the norm
    of its change (:func:`_leaf_gaps`), of ``got`` (or of the reference's
    steps ``control``) against the reference's ``want``."""
    got = got or control
    gap, _ = _leaf_gaps(got["deltas"], want["deltas"], _moved(want))
    return {"window_loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                                        want["losses"])),
            "window_delta_gap_med": float(np.median(gap))}


def readings(got: dict, want: dict) -> dict:
    """Every number the check can compare, of ``got`` against the
    reference's ``want``: ``loss_gap``, the largest relative gap of a step's
    loss, and ``loss1_gap`` the first step's; for the first gradients
    (``grad``) and the changes after the last step (``delta``) the gap of
    each parameter's norms (``_gap``) and the norm of their difference
    (``_diff``), each against the larger of the reference's norm of that
    parameter and of the median parameter, by the worst parameter and by
    the median one (``_med``). Parameters whose reference gradient is under
    a thousandth of the median parameter's move by rounding alone and are
    left out of the changes."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
           "loss1_gap": abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])}
    for what, leaves in (("grad", sorted(got["grads"])), ("delta", _moved(want))):
        gap, diff = _leaf_gaps(got[what + "s"], want[what + "s"], leaves)
        out.update({f"{what}_gap": max(gap), f"{what}_gap_med": float(np.median(gap)),
                    f"{what}_diff": max(diff), f"{what}_diff_med": float(np.median(diff))})
    return out
