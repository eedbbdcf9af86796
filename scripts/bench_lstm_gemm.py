"""Time and accuracy of the BiLSTM's tensor-core GEMM (csrc/lstm_gemm.cu),
mode by mode, on one CUDA card.

For each mode (proj, gates, dx, dw, gates_xp), storage dtype (fp32, bf16), model count
S (1, 24) and input set, at the flagship layer (B=64, T=73, I=256, H=128):
the kernel's median time over --reps calls (CUDA events), and the largest
error, against an fp64 evaluation of the same products, of

- the kernel;
- the plain fp32 version (``lstm.bilstm_gemm_plain``, cuBLAS in full fp32);
- the same products with the fp32 operands rounded to TF32 first, which is
  what a kernel taking one TF32 pass would at best compute.

Input sets: ``layer`` has x ~ N(0, 1), the weights uniform in +-1/sqrt(H)
(nn.LSTM's init), h_seq the layer's own forward and dgates ~ N(0, 0.01^2);
``unit`` has dgates ~ N(0, 1) (as the GEMM's gpu tests draw them).

    python3 scripts/bench_lstm_gemm.py [--root DIR] [--label NAME] [--reps N]

``--root`` is the checkout whose port is imported (default: this one), so
that two trees can be compared in one session; the JSON lands in
``chiprun_out/gemm_<label>.json``.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def tf32_round(t):
    """fp32 values rounded to TF32 (10-bit mantissa, to nearest, ties away
    from zero, as cvt.rna does); other dtypes unchanged."""
    import torch

    if t.dtype != torch.float32:
        return t
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--label", default="tree")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    from multimodal_sentiment_aanalysis_tpu_torch.kernels import lstm

    if not torch.cuda.is_available():
        print("bench_lstm_gemm: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    b, t, i, h = 64, 73, 256, 128
    rows = []
    for data in ("layer", "unit"):
        for dtype in (torch.float32, torch.bfloat16):
            for s in (1, 24):
                gen = torch.Generator(device=dev).manual_seed(7)
                k = h ** -0.5
                x = torch.randn(s, b, t, i, device=dev, generator=gen)
                w_ih = (torch.rand(s, 2, 4 * h, i, device=dev, generator=gen) * 2 - 1) * k
                w_hh = (torch.rand(s, 2, 4 * h, h, device=dev, generator=gen) * 2 - 1) * k
                bias = (torch.rand(s, 2, 4 * h, device=dev, generator=gen) * 2 - 1) * k
                x, w_ih, w_hh, bias = (a.to(dtype) for a in (x, w_ih, w_hh, bias))
                h_seq = lstm.bilstm_fwd_plain(x, w_ih, w_hh, bias)
                dg = torch.randn(s, b, t, 8 * h, device=dev, generator=gen)
                if data == "layer":
                    dg = dg * 0.01
                ops = (x, w_ih, w_hh, bias)
                xp = lstm.bilstm_gemm_plain("proj", *ops)
                for mode in lstm.GEMM_MODES:
                    # "gates_xp" (a tree that has it) adds the fp32 xp after
                    # its product: xp is not rounded to TF32 in t32
                    kw = {"xp": xp} if mode == "gates_xp" else {}
                    kw64 = {"xp": xp.double()} if mode == "gates_xp" else {}

                    def kern(m=mode, kw=kw):
                        return lstm.bilstm_gemm(m, *ops, h_seq=h_seq, dg=dg, **kw)

                    got = kern()
                    want = lstm.bilstm_gemm_plain(mode, *ops, h_seq=h_seq, dg=dg, **kw)
                    ref = lstm.bilstm_gemm_plain(mode, *(a.double() for a in ops),
                                                 h_seq=h_seq.double(), dg=dg.double(), **kw64)
                    t32 = lstm.bilstm_gemm_plain(
                        mode, *(tf32_round(a).double() for a in (x, w_ih, w_hh)),
                        bias.double(), h_seq=tf32_round(h_seq).double(),
                        dg=tf32_round(dg).double(), **kw64)
                    scale = ref.abs().max().item()
                    err = {name: (v.double() - ref).abs().max().item()
                           for name, v in (("kernel", got), ("fp32", want), ("tf32", t32))}
                    ms = time_ms(kern, args.reps)
                    row = dict(label=args.label, data=data, dtype=str(dtype).removeprefix("torch."),
                               S=s, mode=mode, ms=ms, max_ref=scale,
                               **{f"err_{k}": v for k, v in err.items()},
                               **{f"rel_{k}": v / scale for k, v in err.items()})
                    rows.append(row)
                    print(f"{args.label} {data} {row['dtype']} S={s} {mode}: {ms:.4f} ms, "
                          f"max|ref| {scale:.4g}, err kernel {err['kernel']:.3e} "
                          f"({err['kernel'] / scale:.2e} rel), fp32 {err['fp32']:.3e} "
                          f"({err['fp32'] / scale:.2e}), tf32 {err['tf32']:.3e} "
                          f"({err['tf32'] / scale:.2e})", flush=True)
                del x, w_ih, w_hh, bias, h_seq, dg, xp
                torch.cuda.empty_cache()
    out = ROOT / "chiprun_out" / f"gemm_{args.label}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
