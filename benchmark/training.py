"""What the training entries share: the stacked weights drawn from the
seed, the capture of the program's first three steps through the window's
own call, the faults the check's tests plant, the reference's same three
steps, and the model FLOPs per example.

The capture wraps the trainer's per-step method on the instance for the
first fused call(s) the set-up makes, then removes the wrapper, so the
window calls the trainer untouched. It records, per model: each of the
first three steps' loss, the norm of each leaf of the first gradient as the
optimizer took it (its first moment over ``1 - b1`` after one step), and
the norm of each parameter leaf's and each BatchNorm running statistic's
change over the three steps.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import nn as rnn
from .reference.train import gaps, run_steps

CAPTURED_STEPS = 3
LR_FAULT = 1.25


def leaf_norms(views: dict[str, torch.Tensor]) -> tuple[list[str], torch.Tensor]:
    names = list(views)
    return names, torch.stack([views[n].float().reshape(views[n].shape[0], -1).norm(dim=1)
                               for n in names], 1)


class Capture:
    """The program's first steps, read through a wrapper around the
    trainer's step method ``step_attr`` (its ``params``, ``stats`` and
    ``layout``, and its optimizer ``opt``), whose result gives the
    per-model losses through ``loss_of``."""

    def __init__(self, trainer, step_attr: str, opt, loss_of):
        self.trainer, self.step_attr, self.opt, self.loss_of = trainer, step_attr, opt, loss_of
        self.losses: list[torch.Tensor] = []
        self.grad = self.delta = self.names = self.stats = self.stat_names = None
        self._start = None

    def __enter__(self):
        t = self.trainer
        orig = getattr(t, self.step_attr)
        self._prev = vars(t).get(self.step_attr)

        def wrapped(*args, **kwargs):
            k = len(self.losses)
            if k == 0:
                self._start = (t.params.detach().clone(), t.stats.detach().clone())
            out = orig(*args, **kwargs)
            if k < CAPTURED_STEPS:
                self.losses.append(self.loss_of(out).detach().float().clone())
                if k == 0:
                    g = self.opt.mu.float() / (1.0 - self.opt.b1)
                    self.names, self.grad = leaf_norms(t.layout.params(g))
                if k == CAPTURED_STEPS - 1:
                    p0, s0 = self._start
                    _, self.delta = leaf_norms(t.layout.params(t.params.float() - p0.float()))
                    self.stat_names, self.stats = leaf_norms(
                        t.layout.stats(t.stats.float() - s0.float()))
                    self._start = None
            return out

        setattr(t, self.step_attr, wrapped)
        return self

    def __exit__(self, *exc):
        if self._prev is None:
            delattr(self.trainer, self.step_attr)
        else:  # a wrapper installed before this one stays
            setattr(self.trainer, self.step_attr, self._prev)
        return False

    @property
    def done(self) -> bool:
        return len(self.losses) >= CAPTURED_STEPS

    def readings(self) -> dict:
        return {"names": self.names, "loss": torch.stack(self.losses[:CAPTURED_STEPS], 1),
                "grad": self.grad, "delta": self.delta, "stat_names": self.stat_names,
                "stats": self.stats}


class TrainerEntry:
    """The set-up, faults and release both entries share. A subclass builds
    ``self.trainer`` with its optimizer ``self.opt`` and per-step method
    named ``self.step_attr``, keeps ``self.outputs``, and defines
    ``call()`` (one fused call of the window), ``loss_of(step_result)``
    and ``half_batch(step)`` (the step with half of each batch left out of
    the mean)."""

    def capture(self) -> Capture:
        return Capture(self.trainer, self.step_attr, self.opt, self.loss_of)

    def plant(self, fault: str) -> None:
        """A fault in the timed path, for the check's own tests and its
        calibration: ``frozen`` (a step that leaves the parameters
        unchanged), ``stats_frozen`` (one that leaves the BatchNorm running
        statistics unchanged), ``lr_scaled`` (the learning rate
        ``LR_FAULT`` times too large), ``half_batch``."""
        t = self.trainer
        step = getattr(t, self.step_attr)
        if fault == "frozen":
            self.opt.step = lambda *args, **kwargs: None
        elif fault == "stats_frozen":
            def keep_stats(*args, **kwargs):
                old = t.stats.clone()
                out = step(*args, **kwargs)
                t.stats.copy_(old)
                return out

            setattr(t, self.step_attr, keep_stats)
        elif fault == "lr_scaled":
            self.opt.lr.mul_(LR_FAULT)
        elif fault == "half_batch":
            setattr(t, self.step_attr, self.half_batch(step))
        else:
            raise ValueError(f"no fault {fault!r}")

    def setup(self) -> None:
        """The capture, through the window's own call, then warm calls."""
        cap = self.capture()
        with cap:
            while not cap.done:
                self.call()
        self.program = cap.readings()
        for _ in range(self.wl["warm_calls"]):
            self.call()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.outputs.clear()

    def release(self) -> None:
        del self.trainer, self.opt
        self.outputs.clear()


def draw_weights(spec: list, stats_spec: list, n_models: int, seed: int,
                 device) -> tuple[dict, dict]:
    """Every model's parameters and BatchNorm running stats from the seed,
    drawn on ``device`` (:func:`.reference.nn.draw_stacked`)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return rnn.draw_stacked(spec, n_models, g), rnn.draw_stacked(stats_spec, n_models, g)


def reference_readings(model, cfg: dict, wl: dict, params: dict, stats: dict, batches: list,
                       dropout_seed: int, device, precision: str, lr: float,
                       weight_decay: float, clip) -> dict:
    """The reference's first steps (:func:`.reference.train.run_steps`) in
    ``precision`` (``float32`` for the reference, a lower one for the
    control), TF32 set for the run and restored."""
    num, tf32 = rnn.numerics(precision)
    params = {k: v.to(device) for k, v in params.items()}
    stats = {k: v.to(device) for k, v in stats.items()}
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    rnn.set_tf32(tf32)
    try:
        return run_steps(model, cfg, params, stats, batches,
                         torch.Generator(device=device).manual_seed(dropout_seed),
                         lr=lr, weight_decay=weight_decay, clip=clip,
                         block=wl["reference_block"], num=num,
                         draws=model.draws(cfg, wl["models"], wl["batch"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def compare(prog: dict, ref: dict, wl: dict) -> dict[str, float]:
    """The cell's numbers (:func:`.reference.train.gaps`), as its workload's
    ``compare`` entry chooses them."""
    return gaps(prog, ref, **wl.get("compare", {}))


def flops_per_example(model, cfg: dict, spec: list, stats_spec: list, batch: dict,
                      rows: int) -> float:
    """Model FLOPs of one model's forward and backward over ``batch`` (meta
    tensors), counted by ``FlopCounterMode`` (products only), per example;
    dropout is left out, which changes no product."""
    meta = torch.device("meta")
    p = {n: torch.empty(s, device=meta, requires_grad=True) for n, s, _ in spec}
    st = {n: torch.empty(s, device=meta) for n, s, _ in stats_spec}
    counter = FlopCounterMode(display=False)
    draws = model.draws(cfg, 1, rows)
    n_stem = sum(1 for kind, _ in draws if kind == "stem")
    n_keep = len(draws) - n_stem
    with counter:
        loss, _ = model.loss(rnn.Numerics(), cfg, p, st, batch, [None] * n_stem,
                             [None] * n_keep)
        torch.autograd.grad(loss, [v for v in p.values()], allow_unused=True)
    return counter.get_total_flops() / rows


def gather(data: dict, rows: torch.Tensor) -> dict:
    """Rows ``(S, B)`` of every array: ``(S, B, ...)``."""
    flat = rows.reshape(-1)
    return {k: v.index_select(0, flat).view(*rows.shape, *v.shape[1:]) for k, v in data.items()}


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)
