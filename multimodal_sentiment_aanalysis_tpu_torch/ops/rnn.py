"""LSTM primitives with PyTorch ``nn.LSTM`` numerics.

Counterpart of ``multimodal_sentiment_aanalysis_tpu/ops/rnn.py``. Gate order
is torch's (i, f, g, o) and the biases enter as ``b_ih + b_hh``, so the
parameters are ``nn.LSTM``'s ``weight_ih_l{k}(_reverse)`` etc. as they are.
:func:`lstm` is plain PyTorch; :func:`bilstm_recurrence` is too on the CPU
and row 1's recurrence kernel on a card; :func:`bilstm_layer` sends a CUDA
tensor to the BiLSTM kernels
(:func:`..kernels.lstm.fused_bilstm_layer`, forward and backward) and a CPU
tensor down the plain path, whose gradient is autograd's, whatever the
schedule: the schedules differ only in which kernels compute the same
function.
"""

from __future__ import annotations

import torch

from ..kernels.lstm import Params, bilstm_rec, check_schedule, fused_bilstm_layer


def _cell(gates: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
         b_ih: torch.Tensor, b_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Single-direction LSTM layer, ``(B, T, I) -> (B, T, H)``; the input
    projection of all steps is one matmul ahead of the step loop."""
    if reverse:
        x = x.flip(1)
    xp = x @ w_ih.T + (b_ih + b_hh)  # (B, T, 4H)
    h = xp.new_zeros(x.shape[0], w_hh.shape[1])
    c = h
    hs = []
    for t in range(x.shape[1]):
        h, c = _cell(xp[:, t] + h @ w_hh.T, c)
        hs.append(h)
    out = torch.stack(hs, dim=1)
    return out.flip(1) if reverse else out


def bilstm_recurrence(xf: torch.Tensor, xb: torch.Tensor, whf: torch.Tensor,
                      whb: torch.Tensor) -> torch.Tensor:
    """The BiLSTM recurrence given pre-projected inputs.

    ``xf``/``xb`` are ``x @ W_ih^T + b`` for the forward direction and the
    time-flipped reverse direction, each ``(B, T, 4H)``. Both directions
    step together with a ``(2, B, H)`` state. Returns ``(B, T, 2H)`` in
    torch's ``[forward, backward]`` order.

    A CUDA tensor runs row 1's recurrence kernel
    (:func:`..kernels.lstm.bilstm_rec`, the op ``msa_torch::bilstm_rec``)
    over the packed fp32 projection ``[xf | xb]`` with ``xb`` flipped back
    to actual time, ``w_hh`` in its own dtype (the kernel's bf16 form for
    bf16 weights: fp32 arithmetic, ``h`` stored in bf16); the result is in
    the weights' dtype. A CPU tensor steps the plain scan below.
    """
    if xf.device.type == "cuda":
        xp = torch.cat([xf, xb.flip(1)], dim=-1).float()
        return bilstm_rec(xp, torch.stack([whf, whb]))
    xp = torch.stack([xf, xb])                     # (2, B, T, 4H)
    w_hh_t = torch.stack([whf, whb]).transpose(1, 2)  # (2, H, 4H)
    h = xf.new_zeros(2, xf.shape[0], whf.shape[1])
    c = h
    hs = []
    for t in range(xf.shape[1]):
        h, c = _cell(xp[:, :, t] + torch.bmm(h, w_hh_t), c)
        hs.append(h)
    hs = torch.stack(hs, dim=2)  # (2, B, T, H)
    return torch.cat([hs[0], hs[1].flip(1)], dim=-1)


def bilstm_layer(x: torch.Tensor, fwd: Params, bwd: Params, schedule: str = "v9") -> torch.Tensor:
    """Bidirectional layer ``(B, T, I) -> (B, T, 2H)``; ``fwd``/``bwd`` are
    ``(w_ih, w_hh, b_ih, b_hh)`` in torch layout; ``schedule`` names the
    kernels of a CUDA tensor (:data:`..kernels.lstm.SCHEDULES`)."""
    if x.device.type == "cuda":
        return fused_bilstm_layer(x, fwd, bwd, schedule=schedule)
    check_schedule(schedule, x.dtype)  # the CPU scan serves every schedule
    wif, whf, bif, bhf = fwd
    wib, whb, bib, bhb = bwd
    xf = x @ wif.T + (bif + bhf)
    xb = x.flip(1) @ wib.T + (bib + bhb)
    return bilstm_recurrence(xf, xb, whf, whb)


def bilstm_stack(x: torch.Tensor, layers: list[dict[str, torch.Tensor]]) -> torch.Tensor:
    """Multi-layer BiLSTM (torch ``nn.LSTM(num_layers=n, bidirectional=True)``).

    ``layers[k]`` holds the JAX package's keys ``w_ih_fwd, w_hh_fwd,
    b_ih_fwd, b_hh_fwd`` and the ``_bwd`` counterparts, in torch shapes.
    Layer k>0 consumes the (B, T, 2H) concat of layer k-1 (torch semantics,
    dropout=0 default); each layer is :func:`bilstm_layer`.
    """
    out = x
    for p in layers:
        out = bilstm_layer(
            out,
            (p["w_ih_fwd"], p["w_hh_fwd"], p["b_ih_fwd"], p["b_hh_fwd"]),
            (p["w_ih_bwd"], p["w_hh_bwd"], p["b_ih_bwd"], p["b_hh_bwd"]),
        )
    return out
