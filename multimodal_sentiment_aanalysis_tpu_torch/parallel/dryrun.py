"""A multi-rank dry run at flagship width, and the launcher it runs on.

Counterpart of ``__graft_entry__.dryrun_multichip`` (JAX, one process
driving ``n`` devices): :func:`dryrun_multichip` starts ``n`` ranks
(:func:`spawn_ranks`) and each runs :func:`dryrun_rank`:

1. batch data parallelism: one :func:`.dp.make_dp_train_step` step of the
   full phased objective (CE on both heads plus the three InfoNCE terms)
   with the ``fusion_arousal`` grad and update sets, on a global batch of
   2 rows a rank: the loss is finite, the parameters move, and the metric
   count is the global batch;
2. subject sharding: one :class:`..train.VectorizedLOSOTrainer` step with
   one flagship model a rank, every per-model loss finite;
3. tensor parallelism: the flagship sharded by JAX's specs on a ``(n /
   tp, tp)`` mesh (``tp = 2`` where ``n`` is even, else 1), one
   :func:`.dp.global_batch_step` step of the full objective in train mode
   under ``AdamW(1e-4, weight_decay=1e-4)`` on the global batch of
   flavour 1, as ``__graft_entry__.dryrun_multichip``'s flavour 3: the loss
   is finite and the parameters move.

:func:`spawn_ranks` starts ``n`` processes (``spawn``), joins them through
a ``FileStore`` in a fresh temporary directory, gives every process group
a timeout, and joins the processes within a time limit: a rank that fails
or hangs fails the launch. Ranks that build a CUDA kernel at the same time
are safe: :mod:`..kernels._build` writes each library through an atomic
``os.replace``.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import make_mesh, mesh_device, rank_seed


def _rank_entry(fn: Callable, rank: int, world: int, backend: str, device_type: str,
                store_path: str, out_dir: str, timeout_s: float, threads: int,
                args: tuple) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        if device_type == "cuda":
            os.environ["LOCAL_RANK"] = str(rank % torch.cuda.device_count())
        result = fn(make_mesh(world, device_type=device_type), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, n_ranks: int, args: tuple = (), *, backend: str | None = None,
                device_type: str = "cuda", timeout: float = 600.0,
                collective_timeout: float = 60.0) -> list[Any]:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` new processes, one rank each,
    and return each rank's result (pickled through a file), in rank order.
    ``fn`` must be importable (a module-level function). The ranks run on
    the card unless ``device_type="cpu"``; on ``cuda`` rank r takes card
    ``r % device_count``. ``backend`` None picks NCCL where every rank has a
    card of its own, ``gloo`` otherwise (several ranks sharing a card, which
    NCCL refuses, or the CPU). Each rank runs as many torch threads as
    the caller. A rank that raises, or a launch that
    outlasts ``timeout`` seconds, raises here (every rank is stopped); a
    collective waits at most ``collective_timeout`` seconds."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn_ranks: no CUDA device here; pass device_type='cpu' for "
                           "ranks on the CPU")
    if backend is None:
        nccl = device_type == "cuda" and torch.cuda.device_count() >= n_ranks
        backend = "nccl" if nccl else "gloo"
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_entry,
                             args=(fn, r, n_ranks, backend, device_type,
                                   os.path.join(tmp, "store"), tmp, collective_timeout,
                                   torch.get_num_threads(), args))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}"
                              + (" (killed at the time limit)" if p.exitcode == -9 else ""))
        if errors:
            raise RuntimeError(f"{n_ranks}-rank launch of {fn.__name__} failed:\n"
                               + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n_ranks)]


def _example_batch(rng: np.random.Generator, n: int, device: torch.device,
                   eeg_time: int = 585) -> dict[str, torch.Tensor]:
    """``__graft_entry__._example_batch``'s arrays at flagship shapes."""
    batch = {
        "eeg": rng.normal(size=(n, 32, eeg_time)).astype(np.float32),
        "eye": rng.normal(size=(n, 38)).astype(np.float32),
        "pps": rng.normal(size=(n, 230)).astype(np.float32),
        "arousal": rng.integers(0, 3, n).astype(np.int64),
        "valence": rng.integers(0, 3, n).astype(np.int64),
        "mask": np.ones(n, np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def dryrun_rank(mesh, print_lines: bool = True) -> list[str]:
    """One rank's share of :func:`dryrun_multichip` on ``mesh``; returns the
    lines rank 0 prints."""
    from torch.func import functional_call

    from ..data.pipeline import DeviceDataset
    from ..models import MultimodalTransformerModel
    from ..ops.losses import masked_accuracy, masked_cross_entropy
    from ..train import PHASES, VectorizedLOSOTrainer, make_masked_adamw, module_mask
    from .dp import make_dp_train_step

    n, device = mesh.size(), mesh_device(mesh)
    lines = []
    # flavour 1: batch data parallelism of the full phased objective
    rng = np.random.default_rng(0)
    batch = _example_batch(rng, 2 * n, device)
    model = MultimodalTransformerModel(device=device, generator=torch.Generator().manual_seed(0))
    model.train()

    def loss_fn(params, stats, b, generator):
        a, v, c1, c2, c3 = functional_call(
            model, {**params, **stats}, (b["eeg"], b["eye"], b["pps"]),
            {"labels": (b["arousal"], b["valence"], b["mask"]), "generator": generator})
        loss = (masked_cross_entropy(a, b["arousal"], b["mask"])
                + masked_cross_entropy(v, b["valence"], b["mask"]) + c1 + c2 + c3)
        m = b["mask"].sum()
        return loss, torch.stack([loss * m, masked_accuracy(a, b["arousal"], b["mask"]) * m, m])

    spec = PHASES["fusion_arousal"]
    params = dict(model.named_parameters())
    update_mask = module_mask(params, spec.update_modules)
    stats = {k: v for k, v in model.named_buffers() if "running" in k}
    step = make_dp_train_step(loss_fn, make_masked_adamw(model, update_mask, 1e-4, 1e-4), mesh,
                              clip_norm=1.0, grad_mask=module_mask(params, spec.grad_modules),
                              update_mask=update_mask)
    before = {k: p.detach().clone() for k, p in params.items()}
    generator = torch.Generator(device=device).manual_seed(1 + mesh.get_local_rank())
    sums = step(params, stats, batch, generator).cpu()
    count = float(sums[2])
    if count != 2 * n:
        raise RuntimeError(f"metric count {count} != batch {2 * n}")
    loss = float(sums[0]) / count
    if not np.isfinite(loss):
        raise RuntimeError("non-finite DP loss")
    moved = max(float((p.detach() - before[k]).abs().max()) for k, p in params.items())
    if not moved > 0:
        raise RuntimeError("the DP step did not update the parameters")
    lines.append(f"dryrun_multichip({n}): batch-DP OK — loss {loss:.4f}, "
                 f"max param delta {moved:.2e}")

    # flavour 2: subject-sharded LOSO, one flagship model a rank, one step
    ex, bsz = 8, 8
    arrays = {k: v.cpu().numpy() for k, v in _example_batch(rng, n * ex, device).items()}
    arrays.pop("mask")
    vt = VectorizedLOSOTrainer(
        MultimodalTransformerModel(device=device, generator=torch.Generator().manual_seed(2)),
        DeviceDataset(arrays, device), n, ex, batch_size=bsz, seed=3, mesh=mesh)
    plans, masks = (torch.as_tensor(vt.blocks.local(a), device=device)
                    for a in vt._epoch_plans())
    sums = vt._train_step(plans[:, 0], masks[:, 0], vt._active())
    losses = vt.blocks.gather(sums[:, 0] / sums[:, 3].clamp_min(1.0)).cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite subject-sharded losses {losses}")
    lines.append(f"dryrun_multichip({n}): subject-sharded OK — {vt.n_total} flagship models, "
                 "per-model losses finite")
    lines.append(_tensor_parallel(mesh, batch, device))
    if print_lines and mesh.get_local_rank() == 0:
        print("\n".join(lines), flush=True)
    return lines


def _tensor_parallel(mesh, batch: dict, device: torch.device) -> str:
    """Flavour 3 on ``mesh``'s ranks; returns its line."""
    from ..models import MultimodalTransformerModel
    from ..ops.losses import masked_cross_entropy
    from ..train import make_adamw
    from .dp import global_batch_step
    from .tp import DATA, make_mesh_2d, param_partition_specs, shard_by_specs

    n = mesh.size()
    tp = 2 if n % 2 == 0 else 1
    mesh2d = make_mesh_2d(n // tp, tp, device_type=mesh.device_type)
    model = MultimodalTransformerModel(device=device, generator=torch.Generator().manual_seed(0))
    sharded = shard_by_specs(mesh2d, model, param_partition_specs(model, tp))
    sharded.train()
    optimizer = make_adamw([{"params": list(sharded.parameters())}], 1e-4, 1e-4)
    generator = torch.Generator(device=device).manual_seed(
        rank_seed(4, mesh2d.get_local_rank(DATA)))

    def step_fn(state, b):
        m, opt = state
        opt.zero_grad()
        a, v, c1, c2, c3 = m(b["eeg"], b["eye"], b["pps"],
                             labels=(b["arousal"], b["valence"], b["mask"]),
                             generator=generator)
        loss = (masked_cross_entropy(a, b["arousal"], b["mask"])
                + masked_cross_entropy(v, b["valence"], b["mask"]) + c1 + c2 + c3)
        loss.backward()
        opt.step()
        return state, {"loss": loss.detach()}

    before = {k: p.detach().clone() for k, p in sharded.named_parameters()}
    _, metrics = global_batch_step(step_fn, mesh2d)((sharded, optimizer), batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError("non-finite TP loss")
    moved = max(float((p.detach() - before[k]).abs().max())
                for k, p in sharded.named_parameters())
    if not moved > 0:
        raise RuntimeError("the TP step did not update the parameters")
    return (f"dryrun_multichip({n}): tensor-parallel OK — (data={n // tp}, model={tp}) mesh, "
            f"loss {loss:.4f}")


def dryrun_multichip(n_devices: int, device_type: str = "cuda",
                     timeout: float = 900.0) -> list[str]:
    """Start ``n_devices`` ranks and run :func:`dryrun_rank` on each: NCCL
    over ``n_devices`` cards where the machine has them, ``gloo`` otherwise
    (ranks sharing cards, or on the CPU with ``device_type="cpu"``).
    Returns rank 0's lines."""
    return spawn_ranks(dryrun_rank, n_devices, device_type=device_type, timeout=timeout)[0]
