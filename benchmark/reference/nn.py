"""Functional float32 layers of the references, and their weight specs.

One model's forward is written for a single model's tensors; the trainers'
references ``torch.func.vmap`` it over a block of models. Every product
(linear, convolution, LSTM gate product) reads its operands through
:class:`Numerics`, which is the identity for the reference and rounds to a
lower precision for the control (:func:`numerics`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-5
BN_MOMENTUM = 0.1


class Numerics:
    """Rounding of every product's operands: ``None`` for float32, or a
    float8 dtype, the operand scaled by its largest magnitude onto the
    format's range, rounded and scaled back (the forward rounds; the
    gradient passes straight through)."""

    def __init__(self, operand_dtype: torch.dtype | None = None):
        self.operand_dtype = operand_dtype

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.operand_dtype is None:
            return x
        top = torch.finfo(self.operand_dtype).max
        scale = top / x.detach().abs().amax().clamp_min(1e-30)
        r = (x.detach() * scale).to(self.operand_dtype).to(x.dtype) / scale
        return x + (r - x.detach())


def numerics(name: str) -> tuple[Numerics, bool]:
    """``(operand rounding, allow TF32)`` of a precision: ``float32``,
    ``tf32`` (the card's TF32 products) or ``fp8`` (e4m3 operands)."""
    if name == "float32":
        return Numerics(), False
    if name == "tf32":
        return Numerics(), True
    if name == "fp8":
        return Numerics(torch.float8_e4m3fn), False
    raise ValueError(f"unknown precision {name!r}")


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


# --------------------------------------------------------------------------
# weight specs: (name, shape, rule) with rule ("uniform", bound) or
# ("const", value); the benchmark draws every model's weights from them
# --------------------------------------------------------------------------


def linear_spec(name: str, n_in: int, n_out: int) -> list:
    b = 1.0 / math.sqrt(n_in)
    return [(f"{name}.weight", (n_out, n_in), ("uniform", b)),
            (f"{name}.bias", (n_out,), ("uniform", b))]


def conv_spec(name: str, c_in: int, c_out: int, k: int) -> list:
    b = 1.0 / math.sqrt(c_in * k)
    return [(f"{name}.weight", (c_out, c_in, k), ("uniform", b)),
            (f"{name}.bias", (c_out,), ("uniform", b))]


def norm_spec(name: str, width: int) -> list:
    return [(f"{name}.weight", (width,), ("const", 1.0)),
            (f"{name}.bias", (width,), ("const", 0.0))]


def mha_spec(name: str, e: int) -> list:
    return [(f"{name}.in_proj_weight", (3 * e, e), ("uniform", math.sqrt(6.0 / (4 * e)))),
            (f"{name}.in_proj_bias", (3 * e,), ("const", 0.0)),
            (f"{name}.out_proj.weight", (e, e), ("uniform", 1.0 / math.sqrt(e))),
            (f"{name}.out_proj.bias", (e,), ("const", 0.0))]


def lstm_spec(name: str, n_in: int, hidden: int, layers: int) -> list:
    b = 1.0 / math.sqrt(hidden)
    out = []
    for k in range(layers):
        width = n_in if k == 0 else 2 * hidden
        for sfx in ("", "_reverse"):
            out += [(f"{name}.weight_ih_l{k}{sfx}", (4 * hidden, width), ("uniform", b)),
                    (f"{name}.weight_hh_l{k}{sfx}", (4 * hidden, hidden), ("uniform", b)),
                    (f"{name}.bias_ih_l{k}{sfx}", (4 * hidden,), ("uniform", b)),
                    (f"{name}.bias_hh_l{k}{sfx}", (4 * hidden,), ("uniform", b))]
    return out


def bn_stats_spec(name: str, width: int) -> list:
    return [(f"{name}.running_mean", (width,), ("const", 0.0)),
            (f"{name}.running_var", (width,), ("const", 1.0))]


def draw_stacked(spec: list, n_models: int, generator: torch.Generator,
                 dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Every model's weights ``{name: (n_models, *shape)}`` by ``spec``: one
    ``torch.rand`` call on the generator's device for all uniform entries,
    ``(2u - 1) bound``; constants filled."""
    device = generator.device
    sizes = [math.prod(shape) for _, shape, rule in spec if rule[0] == "uniform"]
    u = torch.rand((n_models, sum(sizes)), generator=generator, device=device, dtype=dtype)
    parts = iter(u.split(sizes, 1))
    out = {}
    for name, shape, (kind, value) in spec:
        if kind == "uniform":
            out[name] = (next(parts) * (2.0 * value) - value).reshape(n_models, *shape)
        else:
            out[name] = torch.full((n_models, *shape), value, device=device, dtype=dtype)
    return out


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def linear(num: Numerics, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(num.q(x), num.q(p[f"{name}.weight"]), p[f"{name}.bias"])


def layer_norm(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def batch_norm_train(p: dict, stats: dict, new_stats: dict, name: str,
                     x: torch.Tensor, dims) -> torch.Tensor:
    """Batch-statistic BatchNorm over ``dims`` (the biased variance
    ``E[x^2] - E[x]^2`` floored at 0, with gradient), the running stats
    moved toward the batch's by the momentum into ``new_stats``."""
    mean = x.mean(dims)
    var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
    for part, batch in (("running_mean", mean), ("running_var", var)):
        key = f"{name}.{part}"
        new_stats[key] = (1.0 - BN_MOMENTUM) * stats[key] + BN_MOMENTUM * batch.detach()
    shape = [1] * x.dim()
    shape[1] = -1
    return ((x - mean.reshape(shape)) * torch.rsqrt(var + BN_EPS).reshape(shape)
            * p[f"{name}.weight"].reshape(shape) + p[f"{name}.bias"].reshape(shape))


def dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    return x if keep is None else torch.where(keep, x / (1.0 - rate), 0.0)


def mha(num: Numerics, p: dict, name: str, q_in, k_in, v_in, heads: int) -> torch.Tensor:
    """``nn.MultiheadAttention`` (batch first, no attention dropout) over
    ``(B, L, E)`` inputs."""
    e = q_in.shape[-1]
    w = p[f"{name}.in_proj_weight"]
    b = p[f"{name}.in_proj_bias"]
    q, k, v = (F.linear(num.q(t), num.q(wi), bi)
               for t, wi, bi in zip((q_in, k_in, v_in), w.chunk(3), b.chunk(3)))
    d = e // heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    att = torch.softmax((num.q(q) @ num.q(k).transpose(-1, -2)) / math.sqrt(d), dim=-1)
    out = (num.q(att) @ num.q(v)).transpose(1, 2).reshape(q_in.shape[0], q_in.shape[1], e)
    return linear(num, p, f"{name}.out_proj", out)


def lstm_direction(num: Numerics, x: torch.Tensor, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """``nn.LSTM`` numerics, one direction, gates (i, f, g, o): ``(B, T, I)``
    to ``(B, T, H)``."""
    xp = F.linear(num.q(x), num.q(w_ih), b_ih + b_hh)
    h = x.new_zeros(x.shape[0], w_hh.shape[1])
    c = h
    out = []
    for t in range(x.shape[1]):
        i, f, g, o = (xp[:, t] + F.linear(num.q(h), num.q(w_hh))).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, 1)


def bilstm(num: Numerics, p: dict, name: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    for k in range(layers):
        def par(sfx):
            return [p[f"{name}.{part}_l{k}{sfx}"]
                    for part in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        fwd = lstm_direction(num, x, *par(""))
        bwd = lstm_direction(num, x.flip(1), *par("_reverse")).flip(1)
        x = torch.cat([fwd, bwd], -1)
    return x


def sincos_row0(width: int, like: torch.Tensor) -> torch.Tensor:
    """Row 0 of the sin/cos positional table: sin 0 at even, cos 0 at odd."""
    pe = torch.zeros(width, dtype=like.dtype, device=like.device)
    pe[1::2] = 1.0
    return pe


def supervised_infonce(f1, f2, labels, temperature, mask) -> torch.Tensor:
    """In-model supervised InfoNCE: L2-normalised features, similarity over
    the temperature, positives by label equality less the diagonal, the
    row max subtracted, ``-log((pos + 1e-12) / (all + 1e-12))`` averaged over
    the valid rows, whose columns alone enter the denominators."""
    a = F.normalize(f1, dim=1, eps=1e-12)
    b = F.normalize(f2, dim=1, eps=1e-12)
    sim = (a @ b.T) / temperature
    n = sim.shape[0]
    valid = mask.to(sim.dtype)
    pos = (labels[:, None] == labels[None, :]).to(sim.dtype)
    pos = pos * (1.0 - torch.eye(n, dtype=sim.dtype, device=sim.device))
    pos = pos * valid[:, None] * valid[None, :]
    sim = torch.where(valid[None, :] > 0, sim, -1e30)
    sim = sim - sim.amax(1, keepdim=True)
    e = torch.exp(sim)
    loss = -torch.log(((e * pos).sum(1) + 1e-12) / (e.sum(1) + 1e-12))
    return (loss * valid).sum() / valid.sum().clamp_min(1.0)


def masked_ce(logits, labels, mask) -> torch.Tensor:
    per = F.cross_entropy(logits, labels, reduction="none")
    return (per * mask).sum() / mask.sum().clamp_min(1.0)


def ntxent_two_view(z1, z2, labels, temperature: float) -> torch.Tensor:
    """Two-view supervised NT-Xent over the 2B stacked normalised views:
    positives by label equality less the diagonal, each row's
    log-probability against its exp-sum without the diagonal, summed over
    its positives and divided by their count."""
    z = torch.cat([F.normalize(z1, dim=1, eps=1e-12), F.normalize(z2, dim=1, eps=1e-12)])
    sim = (z @ z.T) / temperature
    lab = torch.cat([labels, labels])
    eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
    pos = torch.where(eye, 0.0, (lab[:, None] == lab[None, :]).to(sim.dtype))
    denom = torch.where(eye, 0.0, torch.exp(sim)).sum(1, keepdim=True)
    log_prob = sim - torch.log(denom + 1e-8)
    return (-(pos * log_prob).sum(1) / (pos.sum(1) + 1e-8)).mean()
