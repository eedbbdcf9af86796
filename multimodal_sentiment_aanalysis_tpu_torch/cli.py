"""Command-line drivers of the PyTorch port.

Run as ``python -m multimodal_sentiment_aanalysis_tpu_torch.cli <command>``.
The subcommands of the JAX package's ``cli.py``, each driving the port's
library as the JAX one drives the JAX library:

- ``inspect``: first-batch shape and finiteness check (reference
  ``printData.py:21-31``);
- ``vloso``: every held-out subject's model at once
  (:class:`~.train.VectorizedLOSOTrainer`);
- ``single``: the single-stage trainer per subject (:class:`~.train.Trainer`);
- ``phased``: the 5-phase curriculum, subject by subject
  (:class:`~.train.MultiTaskTrainer`) or all at once with ``--vectorized``
  (:class:`~.train.VectorizedPhasedTrainer`);
- ``simclr``: contrastive pretrain then frozen finetune, per subject or with
  ``--vectorized`` (:class:`~.train.VectorizedSimCLRTrainer`);
- ``memhacl``: the ME-MHACL pretrain and joint finetune;
- ``eval``: a saved ``.pt``/``.pth`` model on one held-out subject
  (:class:`~.eval.Tester`);
- ``export``: a saved model (or freshly initialised weights) to a
  ``torch.export`` serving artifact (:func:`~.eval.export.export_serving`),
  which :func:`~.eval.export.load_serving` runs with torch and the op
  library alone. The JAX ``--platforms`` is not taken: an artifact runs on
  the device it was exported on (``--device``).

Every subcommand takes ``--synthetic`` (the seeded dataset with the
reference pickle's schema) or ``--data /path/to/hci_data.pkl``, and runs on
the CUDA card unless given ``--device cpu``; with ``--device cuda`` and no
card it raises before any work. ``--results-json`` writes the JAX
package's payload, in plain Python numbers.

``--dp`` (``vloso``, ``phased``, ``phased --vectorized``) runs over a
:func:`~.parallel.make_mesh` mesh of every rank: launched as ``torchrun
--nproc-per-node N -m multimodal_sentiment_aanalysis_tpu_torch.cli ...``,
one rank per card; without ``torchrun``, a one-rank mesh. ``vloso`` and
``phased --vectorized`` shard the subjects over the ranks, ``phased`` (one
subject at a time) splits every batch over them with global-batch
semantics. Only rank 0 prints and writes files (``--results-json``,
checkpoints, ``--save-state``, figures, the history CSV).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

# subcommands that draw figures (with matplotlib) unless --no-plots
PLOTTING = ("phased", "eval")


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card and torch finds none; pass "
                           "--device cpu to run on the CPU")
    return device


def _load_arrays(args) -> tuple[dict, int]:
    """The dataset as normalised feature arrays; returns ``(arrays, ex_nums)``.
    ``--tiny``: 3 subjects x 8 trials with the EEG cut to 64 steps (a
    ``--data`` pickle of that shape still loads)."""
    from .data import RawData, assemble_features, make_synthetic_hci_data

    if args.tiny:
        args.ex_nums = 8
        if args.data and not args.synthetic:
            data = RawData(args.data).data
        else:
            data = make_synthetic_hci_data(seed=args.seed, n_subjects=3, ex_nums=8)
    elif args.synthetic or not args.data:
        data = make_synthetic_hci_data(seed=args.seed)
    else:
        data = RawData(args.data).data
    feats, _ = assemble_features(data, ["eeg", "eye", "pps"], norm="Z_score",
                                 label_type="arousal")
    arrays = {
        "eeg": feats["eeg"].astype(np.float32),
        "eye": feats["eye"].astype(np.float32),
        "pps": feats["pps"].astype(np.float32),
        "arousal": np.asarray(data["arousal_label"]).reshape(-1).astype(np.int64),
        "valence": np.asarray(data["valence_label"]).reshape(-1).astype(np.int64),
    }
    if args.tiny:
        arrays["eeg"] = np.ascontiguousarray(arrays["eeg"][:, :, :64])
    return arrays, args.ex_nums


def _model_kwargs(args) -> dict:
    """Model-dim overrides for ``--tiny``."""
    return {"feat_dim": 32, "eeg_time": 64} if args.tiny else {}


def _generator(seed: int) -> torch.Generator:
    """The CPU generator a module draws its initial weights from."""
    return torch.Generator().manual_seed(seed)


def _flagship(args, device: torch.device, seed: int):
    from .models import MultimodalTransformerModel

    return MultimodalTransformerModel(**_model_kwargs(args), device=device,
                                      generator=_generator(seed))


def _subject_range(args, n_subjects: int) -> list[int]:
    if args.subjects:
        return [int(s) for s in args.subjects.split(",")]
    return list(range(n_subjects))


def _is_main(args) -> bool:
    """Whether this process writes files: rank 0 of a ``--dp`` run, or the
    one process."""
    return args.mesh is None or args.mesh.get_local_rank() == 0


def _plain(value):
    """``value`` with every numpy scalar, array or tensor as plain Python
    numbers and lists, for ``json.dump``."""
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, torch.Tensor):
        return _plain(value.tolist())
    if isinstance(value, np.ndarray):
        return _plain(value.tolist())
    if isinstance(value, np.generic):
        return value.item()
    return value


def _write_results(args, payload: dict) -> None:
    if args.results_json and _is_main(args):
        with open(args.results_json, "w") as f:
            json.dump(_plain(payload), f, indent=2)
        print(f"results written to {args.results_json}")


def _history_row(tester, epochs: list[int], plot_dir: str) -> dict:
    """One subject's row of the history CSV from the Tester's arousal head."""
    from .eval.reporting import Myreport, accumulate_confusion

    r = tester.evaluate(verbose=False, plot_dir=plot_dir)["arousal"]
    cm = accumulate_confusion(r["predictions"], r["labels"], np.zeros((3, 3), np.int64))
    return {"epoch": sum(epochs), "acc": float(r["accuracy"]), "loss": float(r["loss"]),
            "f1-score": float(np.nan_to_num(Myreport().report_f1score(cm)).mean()), "cm": cm}


def _save_history(args, history: dict) -> None:
    import datetime

    from .config import Config
    from .eval.reporting import save_history

    cfg = Config()
    cfg.logging.log_dir = args.history_dir
    path = save_history(cfg, "HCI", datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
                        history)
    print(f"history appended to {path}")


def cmd_phased(args) -> None:
    """LOSO loop over the phased multi-task trainer (reference main.py)."""
    from .data import DeviceDataset, loso_split
    from .eval import Tester
    from .eval.reporting import plot_subject_accuracies
    from .train import MultiTaskTrainer

    device = _device(args)
    arrays, ex_nums = _load_arrays(args)
    n_subjects = arrays["arousal"].shape[0] // ex_nums
    full = DeviceDataset(arrays, device)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    if args.vectorized:
        _phased_vectorized(args, full, n_subjects, ex_nums)
        return
    trainer = None
    results: dict[int, dict[str, float]] = {}
    history: dict[int, dict] = {}
    for sid in _subject_range(args, n_subjects):
        tr_idx, te_idx = loso_split(n_subjects, ex_nums, sid)
        train_ds, test_ds = full.subset(tr_idx), full.subset(te_idx)
        # seed + sid: each subject trains from a fresh init, as in the
        # reference, where the torch global RNG advances between the
        # per-subject model re-instantiations (main.py:66)
        if trainer is None:
            trainer = MultiTaskTrainer(
                _flagship(args, device, args.seed + sid), train_ds, test_ds, test_person=sid,
                checkpoint_dir=args.checkpoint_dir, seed=args.seed + sid,
                verbose=not args.quiet, reset_optimizer_each_epoch=not args.no_reset_optimizer,
                fused_phases=args.fused_phases, mesh=args.mesh)
        else:
            trainer.reset(train_ds, test_ds, test_person=sid, seed=args.seed + sid)
        print(f"===== LOSO test subject {sid} =====")
        final = trainer.run(*args.epochs, save=True, plot=not args.no_plots)
        results[sid] = final
        print(f"subject {sid}: arousal acc {final.get('a_acc', float('nan')):.2%} "
              f"valence acc {final.get('v_acc', float('nan')):.2%}")
        if args.history_dir:
            history[sid] = _history_row(Tester(trainer.model, test_ds), args.epochs,
                                        args.checkpoint_dir)
    a = float(np.mean([r.get("a_acc", float("nan")) for r in results.values()]))
    v = float(np.mean([r.get("v_acc", float("nan")) for r in results.values()]))
    print(f"LOSO mean: arousal {a:.2%} valence {v:.2%}")
    if args.history_dir and history and _is_main(args):
        _save_history(args, history)
    if not args.no_plots and _is_main(args):
        plot_subject_accuracies([results[k]["a_acc"] for k in sorted(results)],
                                f"{args.checkpoint_dir}/subject_accuracies.png")
    _write_results(args, {"per_subject": {str(k): v for k, v in results.items()},
                          "mean_arousal_acc": a, "mean_valence_acc": v})


def _phased_vectorized(args, full, n_subjects: int, ex_nums: int) -> None:
    """All subjects' 5-phase curricula at once
    (:class:`~.train.VectorizedPhasedTrainer`; subject s from seed + s)."""
    from .eval import Tester
    from .eval.reporting import plot_subject_accuracies
    from .train import VectorizedPhasedTrainer

    if args.subjects:
        print("note: --vectorized trains ALL subjects; --subjects ignored")
    model = _flagship(args, full.device, args.seed)
    trainer = VectorizedPhasedTrainer(
        model, full, n_subjects, ex_nums, seed=args.seed,
        compute_dtype="bfloat16" if args.bf16 else None, verbose=not args.quiet,
        reset_optimizer_each_epoch=not args.no_reset_optimizer, early_stop=args.early_stop,
        mesh=args.mesh)
    if args.resume:
        trainer.restore_state(args.resume)
        print(f"resumed from {args.resume}")
    res = trainer.run(*args.epochs)
    if args.early_stop and not args.quiet:
        for phase in trainer._phase_sched:
            print(trainer.stop_report(phase))
    if args.save_state:
        print(f"state saved to {trainer.save_state(args.save_state)}")
    for sid in range(n_subjects):
        print(f"subject {sid}: arousal acc {res['per_subject_arousal'][sid]:.2%} "
              f"valence acc {res['per_subject_valence'][sid]:.2%}")
    print(f"LOSO mean: arousal {res['mean_arousal_acc']:.2%} "
          f"valence {res['mean_valence_acc']:.2%}")
    trainer.save_checkpoints(args.checkpoint_dir)
    if args.history_dir:
        history = {sid: _history_row(Tester(model, full.subset(trainer.test_idx[sid]),
                                            state_dict=trainer.subject_variables(sid)),
                                     args.epochs, args.checkpoint_dir)
                   for sid in range(n_subjects)}
        if _is_main(args):
            _save_history(args, history)
    if not args.no_plots and _is_main(args):
        plot_subject_accuracies([float(x) for x in res["per_subject_arousal"]],
                                f"{args.checkpoint_dir}/subject_accuracies.png")
    _write_results(args, {
        "per_subject": {str(s): {"a_acc": float(res["per_subject_arousal"][s]),
                                 "v_acc": float(res["per_subject_valence"][s])}
                        for s in range(n_subjects)},
        "mean_arousal_acc": res["mean_arousal_acc"],
        "mean_valence_acc": res["mean_valence_acc"],
    })


def _simclr_modules(args, device: torch.device) -> tuple:
    """Encoder, projection head and classifier, from seed, seed + 1, seed + 2."""
    from .models import Classifier, MultiModalEncoder, ProjectionHead

    mk = _model_kwargs(args)
    feat = mk.get("feat_dim", 256)
    return (MultiModalEncoder(feat, eeg_time=mk.get("eeg_time", 585), device=device,
                              generator=_generator(args.seed)),
            ProjectionHead(feat, device=device, generator=_generator(args.seed + 1)),
            Classifier(feat, device=device, generator=_generator(args.seed + 2)))


def cmd_simclr(args) -> None:
    """Contrastive pretrain -> frozen finetune LOSO loop (reference train.py)."""
    from .data import DeviceDataset, build_contrastive_pairs, loso_split, subject_ids_array
    from .train import VectorizedSimCLRTrainer, contrastive_pretrain, finetune

    device = _device(args)
    arrays, ex_nums = _load_arrays(args)
    n_subjects = arrays["arousal"].shape[0] // ex_nums
    full = DeviceDataset(arrays, device)
    subject_ids = subject_ids_array(n_subjects, ex_nums)

    if args.vectorized:
        if args.subjects:
            print("note: --vectorized trains ALL subjects; --subjects ignored")
        trainer = VectorizedSimCLRTrainer(*_simclr_modules(args, device), full, n_subjects,
                                          ex_nums, seed=args.seed, verbose=not args.quiet)
        out = trainer.run(args.pretrain_epochs, args.finetune_epochs)
        per = out["per_subject"]
        print(f"LOSO mean: arousal {out['mean_arousal_acc']:.2%} "
              f"valence {out['mean_valence_acc']:.2%}")
        _write_results(args, {
            "per_subject": {str(s): {"a_acc": float(per["a_acc"][s]),
                                     "v_acc": float(per["v_acc"][s])}
                            for s in range(n_subjects)},
            "mean_arousal_acc": out["mean_arousal_acc"],
            "mean_valence_acc": out["mean_valence_acc"],
        })
        return

    results = {}
    for sid in _subject_range(args, n_subjects):
        tr_idx, te_idx = loso_split(n_subjects, ex_nums, sid)
        train_ds, test_ds = full.subset(tr_idx), full.subset(te_idx)
        pair_idx, pair_lab = build_contrastive_pairs(
            arrays["arousal"][tr_idx], arrays["valence"][tr_idx], subject_ids[tr_idx],
            seed=args.seed)
        print(f"===== LOSO test subject {sid} ({len(pair_idx)} pairs) =====")
        # fresh modules a subject: the engines train them in place
        encoder, projector, classifier = _simclr_modules(args, device)
        enc_vars, _, _ = contrastive_pretrain(
            encoder, projector, train_ds, pair_idx, pair_lab, num_epochs=args.pretrain_epochs,
            seed=args.seed, verbose=not args.quiet)
        _, final = finetune(encoder, enc_vars, classifier, train_ds, test_ds,
                            num_epochs=args.finetune_epochs, seed=args.seed,
                            verbose=not args.quiet)
        results[sid] = final
        print(f"subject {sid}: arousal acc {final['a_acc']:.2%} valence acc {final['v_acc']:.2%}")
    a = float(np.mean([r.get("a_acc", float("nan")) for r in results.values()]))
    v = float(np.mean([r.get("v_acc", float("nan")) for r in results.values()]))
    print(f"LOSO mean: arousal {a:.2%} valence {v:.2%}")
    _write_results(args, {"per_subject": {str(k): v for k, v in results.items()},
                          "mean_arousal_acc": a, "mean_valence_acc": v})


def cmd_single(args) -> None:
    """Single-stage CE+contrastive trainer per subject (reference Trainer.py)."""
    from .data import DeviceDataset, loso_split
    from .train import Trainer

    device = _device(args)
    arrays, ex_nums = _load_arrays(args)
    n_subjects = arrays["arousal"].shape[0] // ex_nums
    full = DeviceDataset(arrays, device)
    os.makedirs(args.checkpoint_dir, exist_ok=True)

    results = {}
    for sid in _subject_range(args, n_subjects):
        tr_idx, te_idx = loso_split(n_subjects, ex_nums, sid)
        trainer = Trainer(_flagship(args, device, args.seed), full.subset(tr_idx),
                          full.subset(te_idx), checkpoint_dir=args.checkpoint_dir,
                          seed=args.seed, verbose=not args.quiet)
        print(f"===== LOSO test subject {sid} =====")
        trainer.run(args.epochs[0], test_person=sid)
        results[sid] = {"test_acc": trainer.test_acc[-1], "test_loss": trainer.test_loss[-1]}
        print(f"subject {sid}: test acc {trainer.test_acc[-1]:.2%}")
    a = float(np.mean([r["test_acc"] for r in results.values()]))
    print(f"LOSO mean arousal acc: {a:.2%}")
    _write_results(args, {"per_subject": {str(k): v for k, v in results.items()},
                          "mean_arousal_acc": a})


def cmd_vloso(args) -> None:
    """Every held-out subject's model trained at once
    (:class:`~.train.VectorizedLOSOTrainer`, reference main.py:62-68)."""
    from .data import DeviceDataset
    from .train import VectorizedLOSOTrainer

    device = _device(args)
    arrays, ex_nums = _load_arrays(args)
    n_subjects = arrays["arousal"].shape[0] // ex_nums
    trainer = VectorizedLOSOTrainer(
        _flagship(args, device, args.seed), DeviceDataset(arrays, device), n_subjects, ex_nums,
        seed=args.seed, batch_size=args.batch_size,
        compute_dtype="bfloat16" if args.bf16 else None, early_stop=args.early_stop,
        es_patience=args.es_patience, mesh=args.mesh)
    if args.resume:
        trainer.restore_state(args.resume)
        print(f"resumed from {args.resume}")
    res = trainer.run(args.epochs[0], verbose=not args.quiet, fused=args.fused, chunk=args.chunk)
    out = {
        "mean_arousal_acc": res["mean_arousal_acc"],
        "mean_valence_acc": res["mean_valence_acc"],
        "per_subject_arousal": [float(x) for x in res["per_subject_arousal"]],
        "per_subject_valence": [float(x) for x in res["per_subject_valence"]],
    }
    if args.early_stop:
        out["stop_epochs"] = [int(x) for x in res["stop_epochs"]]
        out["final_arousal_acc"] = res["final_arousal_acc"]
        out["final_valence_acc"] = res["final_valence_acc"]
    if args.save_state:
        print(f"state saved to {trainer.save_state(args.save_state)}")
    _write_results(args, out)


def cmd_memhacl(args) -> None:
    """ME-MHACL: NT-Xent pretrain on the full set, then joint encoder and
    classifier finetune on an 80/20 split (reference ME-MHACL/train.py),
    at full width (``--tiny`` does not shrink it, as in the JAX package)."""
    from .data import (
        DeviceDataset,
        load_emotion_npy,
        make_synthetic_emotion_arrays,
        random_split_indices,
    )
    from .models import MEMHACLClassifier, MEMHACLEncoder, ProjectionHead
    from .train import memhacl_finetune, memhacl_pretrain

    device = _device(args)
    if args.npy_dir and not args.synthetic:
        d = args.npy_dir
        arrays = load_emotion_npy(f"{d}/eeg_data.npy", f"{d}/eye_data.npy",
                                  f"{d}/physio_data.npy", f"{d}/labels.npy")
    else:
        arrays = make_synthetic_emotion_arrays(n=args.n_samples, seed=args.seed)
    full = DeviceDataset(arrays, device)
    tr_idx, va_idx = random_split_indices(len(full), 0.8, seed=args.seed)

    encoder = MEMHACLEncoder(device=device, generator=_generator(args.seed))
    enc_vars, _, _ = memhacl_pretrain(
        encoder, ProjectionHead(device=device, generator=_generator(args.seed + 1)), full,
        num_epochs=args.pretrain_epochs, seed=args.seed, verbose=not args.quiet)
    _, _, metrics = memhacl_finetune(
        encoder, enc_vars, MEMHACLClassifier(device=device, generator=_generator(args.seed + 2)),
        full.subset(tr_idx), full.subset(va_idx), num_epochs=args.finetune_epochs,
        seed=args.seed, verbose=not args.quiet)
    print(f"final: arousal acc {metrics['a_acc']:.2%} valence acc {metrics['v_acc']:.2%}")
    _write_results(args, metrics)


def cmd_eval(args) -> None:
    """Evaluate a saved model on one held-out subject (reference Tester);
    its confusion matrices go to ``--checkpoint-dir`` unless ``--no-plots``."""
    from .data import DeviceDataset, loso_split
    from .eval import Tester

    device = _device(args)
    arrays, ex_nums = _load_arrays(args)
    n_subjects = arrays["arousal"].shape[0] // ex_nums
    full = DeviceDataset(arrays, device)
    sid = int(args.subjects or 0)
    _, te_idx = loso_split(n_subjects, ex_nums, sid)
    tester = Tester(_flagship(args, device, args.seed), full.subset(te_idx))
    results = tester.run(model_path=args.model_path,
                         plot_dir=None if args.no_plots else args.checkpoint_dir)
    _write_results(args, {"arousal_accuracy": results["arousal"]["accuracy"],
                          "valence_accuracy": results["valence"]["accuracy"]})


def cmd_export(args) -> None:
    """Export a model to a ``torch.export`` serving artifact: the weights
    baked into the traced program, loadable without this package's model
    code (:func:`~.eval.export.load_serving`). ``--model-path`` is a
    ``.pt``/``.pth`` state_dict, read as ``eval`` reads it; without it the
    seeded fresh weights are exported (smoke mode, as in JAX). The input
    schema is the data's shapes (``--tiny``: EEG cut to 64 steps)."""
    from .eval.export import export_serving
    from .utils.checkpoint import load_state_dict

    device = _device(args)
    arrays, _ = _load_arrays(args)
    model = _flagship(args, device, args.seed)
    if args.model_path:
        if str(args.model_path).endswith(".msgpack"):
            raise ValueError(f"{args.model_path} is in the JAX package's msgpack format; the "
                             f"port loads torch .pt/.pth state_dicts")
        model.load_state_dict(load_state_dict(args.model_path, device), strict=True)
        print(f"loaded checkpoint {args.model_path}")
    else:
        print("no --model-path: exporting freshly initialized weights (smoke mode)")
    schema = tuple((tuple(arrays[k].shape[1:]), torch.float32) for k in ("eeg", "eye", "pps"))
    blob = export_serving(model, args.output, batch_size=args.batch_size,
                          feat_dim=_model_kwargs(args).get("feat_dim", 256),
                          compute_dtype=torch.bfloat16 if args.bf16 else None,
                          input_schema=schema)
    batch = "polymorphic" if args.batch_size is None else str(args.batch_size)
    print(f"wrote {len(blob)} bytes to {args.output} "
          f"(batch={batch}{', bf16' if args.bf16 else ''}, {device})")
    _write_results(args, {"artifact_bytes": len(blob), "output": args.output})


def cmd_inspect(args) -> None:
    """First-batch shape sanity check (reference printData.py:21-31)."""
    from .data import DeviceDataset

    device = _device(args)
    arrays, ex_nums = _load_arrays(args)
    ds = DeviceDataset(arrays, device)
    batch, _ = next(ds.batches(args.batch_size, shuffle=False))
    print(f"eeg:     {tuple(batch['eeg'].shape)}   expected (B, 32, 585)")
    print(f"eye:     {tuple(batch['eye'].shape)}          expected (B, 38)")
    print(f"pps:     {tuple(batch['pps'].shape)}         expected (B, 230)")
    print(f"arousal: {tuple(batch['arousal'].shape)}  valence: {tuple(batch['valence'].shape)}")
    print(f"samples: {len(ds)} ({len(ds) // ex_nums} subjects x {ex_nums} trials) on {device}")
    for name in ("eeg", "eye", "pps"):
        if not bool(torch.isfinite(batch[name]).all()):
            raise ValueError(f"non-finite values in {name}")
    print("finite-check: OK")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data", default=None, help="path to hci_data.pkl")
    p.add_argument("--synthetic", action="store_true",
                   help="use the deterministic synthetic dataset")
    p.add_argument("--tiny", action="store_true",
                   help="smoke mode: 3-subject synthetic set + shrunken model dims "
                        "(for CI and dry runs)")
    p.add_argument("--subjects", default=None,
                   help="comma-separated held-out subject indices (default all)")
    p.add_argument("--ex-nums", type=int, default=20, dest="ex_nums")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint-dir", default="./checkpoints")
    p.add_argument("--results-json", default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default the CUDA card; no fallback to the CPU)")
    p.add_argument("--debug-nans", action="store_true",
                   help="NaN tripwire: a backward op that returns NaN raises and names the "
                        "forward op that made it (autograd anomaly mode)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="multimodal_sentiment_aanalysis_tpu_torch",
        description="Multimodal sentiment/emotion framework, PyTorch + CUDA port "
                    "(python -m multimodal_sentiment_aanalysis_tpu_torch.cli)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("phased", help="5-phase curriculum LOSO training")
    _add_common(p)
    p.add_argument("--epochs", type=int, nargs=5, default=[50, 70, 50, 10, 100],
                   metavar=("E_EEG", "E_EYE", "E_PPS", "E2", "E3"))
    p.add_argument("--history-dir", default=None,
                   help="append per-experiment acc/F1/CM row to a history CSV in this "
                        "directory (reference common/utils.py history)")
    p.add_argument("--no-reset-optimizer", action="store_true",
                   help="keep Adam moments and plateau-scheduler state across epochs "
                        "(instead of the reference's per-epoch optimizer rebuild, "
                        "MultiTaskTrainer.py:181,237,293,351,412)")
    p.add_argument("--fused-phases", action="store_true",
                   help="run each curriculum phase without a host sync between epochs "
                        "(per-epoch optimizer reset mode only)")
    p.add_argument("--early-stop", action="store_true", dest="early_stop",
                   help="with --vectorized: per-subject per-phase early stopping as (S,) "
                        "lanes (the reference's dormant early_stopping method, "
                        "MultiTaskTrainer.py:517-527)")
    p.add_argument("--vectorized", action="store_true",
                   help="train ALL subjects' curricula at once "
                        "(train.vphased.VectorizedPhasedTrainer)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (float32 master params); --vectorized only")
    p.add_argument("--dp", action="store_true",
                   help="over every rank of a torchrun launch (one a card; one rank without "
                        "torchrun): --vectorized shards the subjects, the sequential loop splits "
                        "every batch (global-batch semantics)")
    p.add_argument("--save-state", default=None, dest="save_state",
                   help="with --vectorized: write a full-state resume checkpoint after the run")
    p.add_argument("--resume", default=None,
                   help="with --vectorized: restore a --save-state checkpoint before training")
    p.set_defaults(fn=cmd_phased)

    p = sub.add_parser("simclr", help="contrastive pretrain + finetune LOSO")
    _add_common(p)
    p.add_argument("--pretrain-epochs", type=int, default=50)
    p.add_argument("--finetune-epochs", type=int, default=30)
    p.add_argument("--vectorized", action="store_true",
                   help="train ALL subjects' pretrain+finetune runs at once "
                        "(train.vsimclr.VectorizedSimCLRTrainer)")
    p.set_defaults(fn=cmd_simclr)

    p = sub.add_parser("single", help="single-stage CE+contrastive trainer")
    _add_common(p)
    p.add_argument("--epochs", type=int, nargs=1, default=[300])
    p.set_defaults(fn=cmd_single)

    p = sub.add_parser("vloso", help="vectorized LOSO: all subject models at once")
    _add_common(p)
    p.add_argument("--epochs", type=int, nargs=1, default=[100])
    p.add_argument("--batch-size", type=int, default=64, dest="batch_size",
                   help="per-model batch (64 = the reference's)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (float32 master params)")
    p.add_argument("--dp", action="store_true",
                   help="shard the subjects over every rank of a torchrun launch (one a card; "
                        "one rank without torchrun)")
    p.add_argument("--fused", action="store_true",
                   help="all epochs on the device with on-device batch plans (no host sync "
                        "in the loop)")
    p.add_argument("--early-stop", action="store_true", dest="early_stop",
                   help="per-subject early stopping (patience 5, best-checkpoint capture) + "
                        "ReduceLROnPlateau as (S,) schedule lanes; --epochs becomes an upper "
                        "bound")
    p.add_argument("--es-patience", type=int, default=5, dest="es_patience",
                   help="early-stop patience (reference default 5)")
    p.add_argument("--chunk", type=int, default=None,
                   help="with --early-stop --fused: epochs per chunk (default 8); the run "
                        "exits at the first chunk boundary where every subject has stopped")
    p.add_argument("--save-state", default=None, dest="save_state",
                   help="write a full-state resume checkpoint (params, BN stats, optimizer, "
                        "generators of all models) after the run")
    p.add_argument("--resume", default=None,
                   help="restore a --save-state checkpoint before training")
    p.set_defaults(fn=cmd_vloso)

    p = sub.add_parser("memhacl", help="ME-MHACL pretrain + joint finetune")
    _add_common(p)
    p.add_argument("--npy-dir", default=None,
                   help="directory with eeg_data/eye_data/physio_data/labels .npy")
    p.add_argument("--n-samples", type=int, default=128, help="synthetic dataset size")
    p.add_argument("--pretrain-epochs", type=int, default=50)
    p.add_argument("--finetune-epochs", type=int, default=30)
    p.set_defaults(fn=cmd_memhacl)

    p = sub.add_parser("eval", help="evaluate a saved .pt/.pth model (Tester)")
    _add_common(p)
    p.add_argument("--model-path", required=True)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("export", help="export a model to a torch.export serving artifact")
    _add_common(p)
    p.add_argument("--model-path", default=None,
                   help="a .pt/.pth state_dict to export; freshly initialized weights if "
                        "omitted (smoke mode)")
    p.add_argument("--output", required=True, help="artifact file to write (e.g. serving.pt2)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="fix the batch dim (default: batch-polymorphic, one artifact serves "
                        "any batch size)")
    p.add_argument("--bf16", action="store_true",
                   help="bake bf16-cast weights into the artifact; logits return fp32")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("inspect", help="first-batch shape sanity check")
    _add_common(p)
    p.add_argument("--batch-size", type=int, default=64)
    p.set_defaults(fn=cmd_inspect)
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if not args.no_plots and args.command in PLOTTING:
        # before any work: a run must not fail at its last line for want of it
        from .eval.reporting import _pyplot

        try:
            _pyplot()
        except ImportError as e:
            raise RuntimeError(f"{args.command} draws figures with matplotlib, which is not "
                               f"installed; pass --no-plots") from e
    if getattr(args, "history_dir", None):
        import pandas  # noqa: F401  (save_history's CSV, written after training)
    if args.debug_nans:
        from .utils import enable_nan_debugging

        enable_nan_debugging(True)
    args.mesh = None
    if getattr(args, "dp", False):
        from .parallel import make_mesh

        _device(args)
        args.mesh = make_mesh(device_type=args.device)
    with contextlib.ExitStack() as stack:
        if not _is_main(args):  # rank 0 alone prints
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        args.fn(args)


if __name__ == "__main__":
    main()
