#!/usr/bin/env python3
"""Readings from which a cell's correctness limits are set.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--faults half_batch lr_scaled --fault-seeds ...] \
        [--out file.jsonl]

For each seed, in one process: the program's first three steps against the
reference's (``program``); with ``--control-seeds``, the reference computed
in the workload's lower ``control`` precision in the program's place
(``control``); with ``--faults``, the program with each fault planted
(``fault:<name>``, :meth:`benchmark.training.TrainerEntry.plant`). Each
reading is one JSON line of the gaps (:func:`benchmark.reference.train.gaps`). The benchmark's own runs never
run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def details(prog: dict, ref: dict) -> dict:
    """Where each gap comes from: every step's worst loss gap, and the
    leaves of the worst grad, update and stats gaps."""
    import torch

    names = prog["names"]
    idx = [ref["names"].index(n) for n in names]
    rl, pl = ref["loss"].double(), prog["loss"].double()
    out = {"loss_by_step": ((pl - rl).abs() / rl.abs()).max(0).values.tolist()}
    rg = ref["grad"][:, idx].double()
    sidx = [ref["stat_names"].index(n) for n in prog["stat_names"]]
    for key, leaves, r in (("grad", names, rg), ("delta", names, ref["delta"][:, idx].double()),
                           ("stats", prog["stat_names"], ref["stats"][:, sidx].double())):
        p = prog[key].double()
        m = r.median(dim=1, keepdim=True).values
        gap = (p - r).abs() / torch.maximum(r, m)
        if key == "delta":
            gap = torch.where(rg >= 1e-3 * rg.median(dim=1, keepdim=True).values, gap, 0.0)
        worst = gap.max(0).values
        top = worst.argsort(descending=True)[:3].tolist()
        out[f"{key}_leaves"] = [[leaves[i], float(worst[i]), float(r[:, i].median()),
                                 float(m.median())] for i in top]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, training

    wl, cfg = harness.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    mod = harness.load_entry(wl["entry"])
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = list(dict.fromkeys(args.seeds + args.control_seeds + args.fault_seeds))
    for seed in seeds:
        kinds = ([("program", None)] if seed in args.seeds else []) + (
            [(f"fault:{f}", f) for f in args.faults] if seed in args.fault_seeds else [])
        ref = entry = None
        for kind, fault in kinds:
            t0 = time.time()
            entry = mod.Entry(cfg, wl, seed, device, fault)
            entry.setup()
            prog = entry.program
            entry.release()
            torch.cuda.empty_cache()
            if ref is None:
                ref = entry.reference_readings("float32")
            emit({"cell": args.workload, "seed": seed, "kind": kind,
                  **training.compare(prog, ref, wl), "s": time.time() - t0, **details(prog, ref)})
        if seed in args.control_seeds:
            t0 = time.time()
            if entry is None:
                entry = mod.Entry(cfg, wl, seed, device)
                entry.release()
            if ref is None:
                ref = entry.reference_readings("float32")
            ctrl = entry.reference_readings(wl["control"])
            emit({"cell": args.workload, "seed": seed, "kind": f"control:{wl['control']}",
                  **training.compare(ctrl, ref, wl), "s": time.time() - t0, **details(ctrl, ref)})
        del entry, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
