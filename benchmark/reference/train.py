"""The reference's first training steps of every model, and the numbers
that compare a program's steps with them.

:func:`run_steps` trains the S models of a stacked state for a few steps
on the batches it is given, drawing each step's dropout bits from its own
generator by the program's documented rule (:func:`draw_step`). The S
models are computed in blocks under ``torch.func.vmap`` so that the
reference fits beside nothing else on the card. The optimizer is AdamW
(b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) after an optional
per-model global-norm clip ``min(1, clip / (norm + 1e-6))``.

What it records: each step's loss ``(S, steps)``, the norm of each leaf of
the first step's gradient as the optimizer takes it (clipped) ``(S, L)``,
the norm of each leaf's change over all the steps ``(S, L)``, and the norm
of each BatchNorm running statistic's change over all the steps ``(S, M)``.
"""

from __future__ import annotations

import torch
from torch.func import grad_and_value, vmap

from . import nn as rnn
from .rules import stem_keep_mask, stem_seeds


def draw_step(generator: torch.Generator, draws: list, n_models: int, rate: float,
              stem_rate: float) -> tuple[list, list]:
    """One step's dropout draws in the forward's order: a stem stage draws
    one int64 seed per model on a card and a uniform ``(S, B, T, C)`` block
    on the CPU; every other site a uniform ``(S, *shape)`` block. Returns
    ``(stem, keeps)``: the seeds or bits of each stem stage, and each other
    site's keep bits ``u >= rate``."""
    stem, keeps = [], []
    cuda = generator.device.type == "cuda"
    for kind, shape in draws:
        if kind == "stem":
            stem.append(stem_seeds(generator, n_models) if cuda else
                        torch.rand((n_models, *shape), generator=generator) >= stem_rate)
        else:
            u = torch.rand((n_models, *shape), generator=generator, device=generator.device)
            keeps.append(u >= rate)
    return stem, keeps


def _stem_block(stem: list, shapes: list, lo: int, hi: int, rate: float, device) -> list:
    out = []
    for s, shape in zip(stem, shapes):
        if s.dtype == torch.bool:
            out.append(s[lo:hi])
        else:
            out.append(torch.stack([stem_keep_mask(int(v), shape, rate, device)
                                    for v in s[lo:hi].tolist()]))
    return out


def _leaf_norms(tree: dict, names: list) -> torch.Tensor:
    return torch.stack([tree[n].reshape(tree[n].shape[0], -1).norm(dim=1) for n in names], 1)


def run_steps(model, cfg: dict, params: dict, stats: dict, batches: list,
              generator: torch.Generator, *, lr: float, weight_decay: float,
              clip: float | None, block: int, num: rnn.Numerics, draws: list) -> dict:
    """``model``: a reference module with ``loss(num, cfg, p, stats, batch,
    stem_keeps, keeps)``. ``params``/``stats``: ``{name: (S, ...)}``
    float32, copied. ``batches``: one ``{key: (S, ...)}`` per step."""
    names, stat_names = list(params), list(stats)
    p = {k: v.detach().clone().float() for k, v in params.items()}
    st = {k: v.detach().clone().float() for k, v in stats.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    st0 = {k: v.clone() for k, v in st.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    n_models = next(iter(p.values())).shape[0]
    stem_shapes = [shape for kind, shape in draws if kind == "stem"]

    def one(pp, ss, batch, stem_keeps, keeps):
        return model.loss(num, cfg, pp, ss, batch, stem_keeps, keeps)

    step_fn = vmap(grad_and_value(one, has_aux=True))
    losses, grad_norms = [], None
    for t, batch in enumerate(batches, 1):
        stem, keeps = draw_step(generator, draws, n_models, cfg["dropout"],
                                cfg["eeg"]["stem_dropout"])
        grads = {k: torch.empty_like(v) for k, v in p.items()}
        loss = torch.empty(n_models, device=generator.device)
        new_stats = {k: v.clone() for k, v in st.items()}
        for lo in range(0, n_models, block):
            hi = min(lo + block, n_models)
            sk = _stem_block(stem, stem_shapes, lo, hi, cfg["eeg"]["stem_dropout"],
                             generator.device)
            g, (lv, ns) = step_fn({k: v[lo:hi] for k, v in p.items()},
                                  {k: v[lo:hi] for k, v in st.items()},
                                  _slice(batch, lo, hi), sk, [k[lo:hi] for k in keeps])
            for k in grads:
                grads[k][lo:hi] = g[k]
            for k, v in ns.items():
                new_stats[k][lo:hi] = v
            loss[lo:hi] = lv
        st = new_stats
        losses.append(loss)
        if clip is not None:
            norm = _leaf_norms(grads, names).square().sum(1).sqrt()
            coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
            grads = {k: v * coef.reshape(-1, *[1] * (v.dim() - 1)) for k, v in grads.items()}
        if t == 1:
            grad_norms = _leaf_norms(grads, names)
        c1, c2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
        for k in names:
            mu[k] = 0.1 * grads[k] + 0.9 * mu[k]
            nu[k] = 0.001 * grads[k] * grads[k] + 0.999 * nu[k]
            upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8) + weight_decay * p[k]
            p[k] = p[k] - lr * upd
    delta = {k: p[k] - p0[k] for k in names}
    moved = {k: st[k] - st0[k] for k in stat_names}
    return {"names": names, "loss": torch.stack(losses, 1), "grad": grad_norms,
            "delta": _leaf_norms(delta, names), "stat_names": stat_names,
            "stats": _leaf_norms(moved, stat_names)}


def _slice(batch, lo: int, hi: int):
    if isinstance(batch, dict):
        return {k: _slice(v, lo, hi) for k, v in batch.items()}
    return batch[lo:hi]


def gaps(prog: dict, ref: dict, loss_steps: int | None = None,
         grad: str = "worst") -> dict[str, float]:
    """The numbers compared, each the worst over models. A leaf's gap is
    ``| |x_prog| - |x_ref| |`` over the larger of the reference leaf's norm
    and the median leaf's.

    - ``loss``: ``|L_prog - L_ref| / |L_ref|`` of each step (of the first
      ``loss_steps`` steps, where given);
    - ``grad``: the gap of each leaf of the first gradient: the worst leaf
      (``grad="worst"``) or the median leaf (``grad="median"``);
    - ``update``: the worst leaf's gap in each leaf's change over the
      steps, leaving out the leaves whose reference gradient is under a
      thousandth of the median leaf's (they move by round-off alone under
      Adam);
    - ``update_median``: the median leaf's gap in the same changes, which
      a wrong learning rate or moment moves by its whole error while the
      round-off of a few leaves does not;
    - ``stats``: the worst BatchNorm running statistic's gap in its change
      over the steps.
    """
    names = prog["names"]
    idx = [ref["names"].index(n) for n in names]
    rl, pl = ref["loss"].double(), prog["loss"].double()
    out = {"loss": float(((pl - rl).abs() / rl.abs())[:, :loss_steps].max())}
    rg = ref["grad"][:, idx].double()
    live = rg >= 1e-3 * rg.median(dim=1, keepdim=True).values

    def leaf_gaps(p, r):
        m = r.median(dim=1, keepdim=True).values
        return (p - r).abs() / torch.maximum(r, m)

    g = leaf_gaps(prog["grad"].double(), rg)
    out["grad"] = float((g.median(dim=1).values if grad == "median" else g).max())
    u = leaf_gaps(prog["delta"].double(), ref["delta"][:, idx].double())
    out["update"] = float(torch.where(live, u, 0.0).max())
    out["update_median"] = float(u.median(dim=1).values.max())
    sidx = [ref["stat_names"].index(n) for n in prog["stat_names"]]
    out["stats"] = float(leaf_gaps(prog["stats"].double(),
                                   ref["stats"][:, sidx].double()).max())
    return out
