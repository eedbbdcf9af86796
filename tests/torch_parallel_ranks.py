"""Rank functions of ``test_torch_port_parallel.py``,
``test_torch_port_parallel_dp.py`` and ``test_torch_port_tp.py``: torch and
the port only.

The test modules import JAX; the ranks they spawn import this module, which
imports neither JAX nor any test module that does. :func:`w2_cases` runs a
module's two-rank cases in one launch and returns what the test compares,
each rank's results gathered to the global models where the trainer shards
them; with ``mesh=None`` a case is the one-process run it is held to.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multimodal_sentiment_aanalysis_tpu_torch.data import (
    DeviceDataset,
    assemble_features,
    make_synthetic_hci_data,
)
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    Classifier,
    MultimodalTransformerModel,
    MultiModalEncoder,
    ProjectionHead,
)
from multimodal_sentiment_aanalysis_tpu_torch.parallel import make_mesh
from multimodal_sentiment_aanalysis_tpu_torch.parallel.dp import (
    global_batch_step,
    make_dp_eval_step,
    make_dp_train_step,
)
from multimodal_sentiment_aanalysis_tpu_torch.parallel.tp import DATA, MODEL
from multimodal_sentiment_aanalysis_tpu_torch.train import (
    MultiTaskTrainer,
    VectorizedLOSOTrainer,
    VectorizedPhasedTrainer,
    VectorizedSimCLRTrainer,
    apply_grad_mask,
)


@pytest.fixture
def one_rank_mesh():
    """A one-rank ``gloo`` mesh in this process (the one-process group
    :func:`make_mesh` starts), destroyed after the test: the test runner's
    workers run many tests in one process."""
    mesh = make_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def hci_arrays(n_subjects: int, ex_nums: int = 8, t_eeg: int = 16) -> dict:
    """The synthetic MAHNOB-HCI set's features, EEG cut to ``t_eeg`` steps."""
    data = make_synthetic_hci_data(seed=5, n_subjects=n_subjects, ex_nums=ex_nums)
    feats, _ = assemble_features(data, ["eeg", "eye", "pps"], norm="Z_score",
                                 label_type="arousal")
    return {"eeg": np.ascontiguousarray(feats["eeg"].astype(np.float32)[:, :, :t_eeg]),
            "eye": feats["eye"].astype(np.float32), "pps": feats["pps"].astype(np.float32),
            "arousal": np.asarray(data["arousal_label"]).astype(np.int64),
            "valence": np.asarray(data["valence_label"]).astype(np.int64)}


def random_arrays(n: int, t_eeg: int, seed: int) -> dict:
    """``tests/test_parallel.py``'s arrays."""
    r = np.random.default_rng(seed)
    return {"eeg": r.normal(size=(n, 32, t_eeg)).astype(np.float32),
            "eye": r.normal(size=(n, 38)).astype(np.float32),
            "pps": r.normal(size=(n, 230)).astype(np.float32),
            "arousal": r.integers(0, 3, n).astype(np.int64),
            "valence": r.integers(0, 3, n).astype(np.int64)}


def tiny_model(feat: int, t_eeg: int) -> MultimodalTransformerModel:
    return MultimodalTransformerModel(feat_dim=feat, eeg_time=t_eeg, dropout=0.0)


def simclr_modules(feat: int, t_eeg: int):
    """The templates; the trainer draws every subject's weights itself."""
    return (MultiModalEncoder(feat, eeg_time=t_eeg, dropout=0.0),
            ProjectionHead(feat, dropout=0.0), Classifier(feat, dropout=0.0))


def all_variables(trainer, n: int) -> list:
    """Every real subject's ``subject_variables`` (a collective: every rank
    calls it)."""
    return [trainer.subject_variables(s) for s in range(n)]


# ----------------------------------------------------------------------
# the cases
def loso_vs_jax(mesh, c):
    """(a) two host-plan epochs from the JAX trainer's stacked init."""
    pt = VectorizedLOSOTrainer(tiny_model(c["feat"], c["t_eeg"]),
                               DeviceDataset(c["arrays"], "cpu"), c["n_subjects"],
                               c["ex_nums"], batch_size=c["batch"], seed=0,
                               mesh=mesh)
    pt.load_stacked_state(c["init"], c["cw"])
    history = [pt.train_epoch() for _ in range(c["epochs"])]
    return {"history": history, "eval": pt.evaluate(), "n_total": pt.n_total,
            "train_idx": pt.train_idx, "test_idx": pt.test_idx,
            "variables": all_variables(pt, c["n_subjects"]),
            "cw": pt.blocks.gather(pt._param_dict(pt.params)["trainer.contrastive_weight"])}


def loso_fused_es(mesh, c):
    """(b) fused early-stop epochs against the unsharded fused run."""
    pt = VectorizedLOSOTrainer(tiny_model(c["feat"], c["t_eeg"]),
                               DeviceDataset(c["arrays"], "cpu"), c["n_subjects"],
                               c["ex_nums"], batch_size=c["batch"], seed=1,
                               early_stop=True, es_patience=1, plateau_patience=0, mesh=mesh)
    out = pt.train_epochs_fused(c["epochs"])
    return {"fused": out, "best": pt.evaluate(best=True), "final": pt.evaluate(),
            "report": pt.stop_report(), "variables": all_variables(pt, c["n_subjects"])}


def phased_epoch(mesh, c):
    """(b) one ``fusion_arousal`` epoch of the vectorized curriculum."""
    vp = VectorizedPhasedTrainer(tiny_model(c["feat"], c["t_eeg"]),
                                 DeviceDataset(c["arrays"], "cpu"), c["n_subjects"],
                                 c["ex_nums"], batch_size=c["batch"], seed=0, verbose=False,
                                 mesh=mesh)
    last = vp.run_phase("fusion_arousal", 1)
    return {"last": last, "metrics": vp.metrics, "variables": all_variables(vp, c["n_subjects"])}


def simclr_epochs(mesh, c):
    """(b) one pretrain and one finetune epoch of the vectorized SimCLR stack."""
    vs = VectorizedSimCLRTrainer(*simclr_modules(c["feat"], c["t_eeg"]),
                                 DeviceDataset(c["arrays"], "cpu"), c["n_subjects"], c["ex_nums"],
                                 batch_size=c["batch"], seed=0, verbose=False, mesh=mesh)
    pre = vs.pretrain(1)
    ft = vs.finetune(1)
    return {"pretrain": pre, "finetune": ft, "variables": all_variables(vs, c["n_subjects"])}


def multitask_vs_jax(mesh, c):
    """(c) ``fusion_arousal`` then ``valence`` from the JAX trainer's init."""
    train, test = (DeviceDataset(a, "cpu") for a in (c["train"], c["test"]))
    mt = MultiTaskTrainer(tiny_model(c["feat"], c["t_eeg"]), train, test,
                          batch_size=c["batch"], seed=5, verbose=False, mesh=mesh)
    mt.model.load_state_dict(c["init"])
    out = {}
    for phase in ("fusion_arousal", "valence"):
        out[phase] = (mt.train_epoch_phase(phase),
                      {k: v.clone() for k, v in mt.model.state_dict().items()})
    out["test"] = mt.evaluate()
    return out


def multitask_grads(mesh, c):
    """(c) one ``eeg`` and one ``fusion_arousal`` step's gradients, summed
    over the ranks, before any update (lr 0, no clip)."""
    train, test = (DeviceDataset(a, "cpu") for a in (c["train"], c["test"]))
    mt = MultiTaskTrainer(tiny_model(c["feat"], c["t_eeg"]), train, test,
                          batch_size=c["batch"], seed=5, verbose=False, mesh=mesh,
                          clip_norm=1e9)
    mt.model.load_state_dict(c["init"])
    idx = torch.arange(c["batch"])
    mask = (idx < c["valid"]).to(torch.float32)
    out = {}
    for phase in ("eeg", "fusion_arousal"):
        mt.model.train()
        apply_grad_mask(mt.model, mt._masks(phase)[0])
        batch = mt.train_data.gather(mt._block(idx))
        batch["mask"] = mt._block(mask)
        sums = mt._sum_over_ranks(mt._train_step(phase, batch, mt._optimizer(phase, 0.0),
                                                  mask.sum()))
        out[phase] = (sums, {n: p.grad.clone() for n, p in mt.model.named_parameters()
                             if p.grad is not None})
        for p in mt.model.parameters():
            p.requires_grad_(True)
    return out


def _ce_loss(model):
    from torch.func import functional_call

    from multimodal_sentiment_aanalysis_tpu_torch.ops.losses import masked_cross_entropy

    def loss_fn(params, stats, b, generator):
        a = functional_call(model, {**params, **stats}, (b["eeg"], b["eye"], b["pps"]))[0]
        loss = masked_cross_entropy(a, b["arousal"], b["mask"])
        return loss, b["mask"].sum()[None]

    return loss_fn


def dp_steps(mesh, c):
    """(d) the ``shard_map`` form's train and eval steps (deterministic CE
    loss, SGD, no clip)."""
    from multimodal_sentiment_aanalysis_tpu_torch.ops.losses import (
        masked_accuracy,
        masked_cross_entropy,
    )

    model = tiny_model(c["feat"], c["t_eeg"])
    model.load_state_dict(c["init"])
    model.eval()
    params = dict(model.named_parameters())
    step = make_dp_train_step(_ce_loss(model), torch.optim.SGD(list(params.values()), lr=1e-2),
                              mesh, clip_norm=None)
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    n = step(params, {}, batch)

    def metrics_fn(params, stats, b):
        a, _ = model(b["eeg"], b["eye"], b["pps"])
        m = b["mask"].sum()
        return {"a_acc": masked_accuracy(a, b["arousal"], b["mask"]) * m,
                "loss": masked_cross_entropy(a, b["arousal"], b["mask"]) * m, "n": m}

    stepped = {k: v.detach().clone() for k, v in params.items()}
    model.load_state_dict(c["init"])
    ev = make_dp_eval_step(metrics_fn, mesh)({}, {}, batch)
    return {"n": n, "params": stepped, "eval": ev}


def global_step(mesh, c):
    """(e) the GSPMD form: a train-mode step of the full objective (CE on
    both heads and the three InfoNCE terms, dropout 0, SGD) on the global
    batch."""
    from multimodal_sentiment_aanalysis_tpu_torch.ops.losses import masked_cross_entropy

    model = tiny_model(c["feat"], c["t_eeg"])
    model.load_state_dict(c["init"])
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)

    def step_fn(state, b):
        m, o = state
        o.zero_grad()
        a, v, c1, c2, c3 = m(b["eeg"], b["eye"], b["pps"],
                             labels=(b["arousal"], b["valence"], b["mask"]))
        loss = (masked_cross_entropy(a, b["arousal"], b["mask"])
                + masked_cross_entropy(v, b["valence"], b["mask"]) + c1 + c2 + c3)
        loss.backward()
        o.step()
        return state, {"loss": loss.detach()}

    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    if mesh is None:
        _, metrics = step_fn((model, opt), batch)
    else:
        _, metrics = global_batch_step(step_fn, mesh)((model, opt), batch)
    return {"loss": metrics["loss"], "state": {k: v.clone() for k, v in model.state_dict().items()}}


def loso_resume(mesh, c):
    """(f) one epoch, ``save_state``, one more epoch."""
    pt = VectorizedLOSOTrainer(tiny_model(c["feat"], c["t_eeg"]),
                               DeviceDataset(c["arrays"], "cpu"), c["n_subjects"],
                               c["ex_nums"], batch_size=c["batch"], seed=0,
                               mesh=mesh)
    pt.train_epoch()
    pt.save_state(c["path"] if mesh is not None else c["path"] + ".one")
    return {"epoch2": pt.train_epoch(), "params": pt.blocks.gather(pt.params),
            "stats": pt.blocks.gather(pt.stats)}


CASES = {"loso_vs_jax": loso_vs_jax, "loso_fused_es": loso_fused_es, "phased": phased_epoch,
         "simclr": simclr_epochs, "multitask_vs_jax": multitask_vs_jax,
         "multitask_grads": multitask_grads, "dp_steps": dp_steps, "global_step": global_step,
         "loso_resume": loso_resume}


def w2_cases(mesh, inputs: dict) -> dict:
    """Every case named in ``inputs`` on ``mesh``, in one launch."""
    torch.manual_seed(0)
    np.random.seed(0)
    return {name: CASES[name](mesh, c) for name, c in inputs.items()}


# ----------------------------------------------------------------------
# tensor parallelism (test_torch_port_tp.py): each case takes a (data,
# model) mesh, or None for the one-process run it is held to
def tp_model(mesh2d, c, **kw):
    """The tiny flagship from ``c["state"]``, sharded by JAX's specs on
    ``mesh2d`` (whole where it is None)."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel import (param_partition_specs,
                                                                   shard_by_specs)

    model = MultimodalTransformerModel(feat_dim=c["feat"], eeg_time=c["t_eeg"], **kw)
    model.load_state_dict(c["state"])
    if mesh2d is None:
        return model
    return shard_by_specs(mesh2d, model, param_partition_specs(model, mesh2d.size(1)))


def whole_state(model) -> dict:
    from multimodal_sentiment_aanalysis_tpu_torch.parallel import gather_state_dict

    sd = gather_state_dict(model) if hasattr(model, "tp") else model.state_dict()
    return {k: v.detach().clone() for k, v in sd.items()}


def whole_grads(model) -> dict:
    """Every parameter's ``.grad``, split ones gathered whole."""
    out = {}
    for mname, m in model.named_modules():
        for name, p in m.named_parameters(recurse=False):
            g, dim = p.grad, getattr(m, "tp_split", {}).get(name)
            out[f"{mname}.{name}" if mname else name] = (g if dim is None
                                                         else m.tp.gather(g, dim)).clone()
    return out


def full_objective(model, b, generator):
    """CE on both heads plus the three InfoNCE terms (JAX's TP step)."""
    from multimodal_sentiment_aanalysis_tpu_torch.ops.losses import masked_cross_entropy

    a, v, c1, c2, c3 = model(b["eeg"], b["eye"], b["pps"],
                             labels=(b["arousal"], b["valence"], b["mask"]),
                             generator=generator)
    return (masked_cross_entropy(a, b["arousal"], b["mask"])
            + masked_cross_entropy(v, b["valence"], b["mask"]) + c1 + c2 + c3)


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def tp_roundtrip(mesh2d, c):
    """Shard, then gather: the whole ``state_dict`` back, and each rank's
    tensors the blocks its specs name."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel import param_partition_specs

    model = tp_model(None, c)
    sharded = tp_model(mesh2d, c)
    specs = param_partition_specs(model, mesh2d.size(1))
    whole, local = model.state_dict(), sharded.state_dict()
    index, size = mesh2d.get_local_rank(MODEL), mesh2d.size(1)
    blocks = {}
    for k, v in whole.items():
        bn_stat = k.endswith(("running_mean", "running_var"))  # placed as their BN's scale
        spec = specs[k.rsplit(".", 1)[0] + ".weight"] if bn_stat else specs.get(k, ())
        if MODEL in spec:
            d = spec.index(MODEL)
            n = v.shape[d] // size
            v = v.narrow(d, index * n, n)
        blocks[k] = torch.equal(local[k], v)
    gathered = whole_state(sharded)
    return {"blocks": blocks,
            "gathered": gathered.keys() == whole.keys()
            and all(torch.equal(gathered[k], v) for k, v in whole.items())}


def tp_eval(mesh2d, c):
    """The eval forward's logits of this rank's data block."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel import batch_sharding

    model = tp_model(mesh2d, c)
    model.eval()
    b = _tensors(c["batch"])
    if mesh2d is not None:
        b = batch_sharding(mesh2d, b)
    with torch.no_grad():
        return {"logits": model(b["eeg"], b["eye"], b["pps"])}


def tp_step(mesh2d, c):
    """``c["steps"]`` steps on the global batch: JAX's SGD-on-CE step in
    eval mode (``objective="ce"``), or the full objective in train mode,
    under SGD 1e-2 or AdamW 1e-4; the losses, the whole state after, and
    (sharded) this rank's replicated parameters."""
    from multimodal_sentiment_aanalysis_tpu_torch.ops.losses import masked_cross_entropy
    from multimodal_sentiment_aanalysis_tpu_torch.parallel.mesh import rank_seed
    from multimodal_sentiment_aanalysis_tpu_torch.train import make_adamw

    model = tp_model(mesh2d, c, dropout=c["dropout"], lstm_schedule=c.get("schedule", "v9"))
    model.train(c["objective"] == "full")
    params = list(model.parameters())
    opt = (make_adamw([{"params": params}], 1e-4, 1e-4) if c.get("adamw")
           else torch.optim.SGD(params, lr=1e-2))
    data_index = 0 if mesh2d is None else mesh2d.get_local_rank(DATA)
    gen = torch.Generator().manual_seed(rank_seed(c["seed"], data_index))

    def step_fn(state, b):
        m, o = state
        o.zero_grad()
        if c["objective"] == "full":
            loss = full_objective(m, b, gen)
        else:
            loss = masked_cross_entropy(m(b["eeg"], b["eye"], b["pps"])[0], b["arousal"],
                                        b["mask"])
        loss.backward()
        o.step()
        return state, {"loss": loss.detach()}

    step = step_fn if mesh2d is None else global_batch_step(step_fn, mesh2d)
    losses = [step((model, opt), _tensors(c["batch"]))[1]["loss"] for _ in range(c["steps"])]
    out = {"loss": torch.stack(losses), "state": whole_state(model)}
    if mesh2d is not None:
        out["replicated"] = {k: p.detach().clone() for k, p in model.named_parameters()
                             if not hasattr(p, "tp_axis")}
    return out


def tp_clip(mesh2d, c):
    """One ``make_dp_train_step`` step (local semantics, a binding
    ``clip_norm=1.0``, SGD 1e-2) of the full objective at dropout 0, and
    the clipped gradients it stepped with; the one-process run sums the
    data blocks' gradients weighted by their rows and clips them."""
    from torch.func import functional_call

    from multimodal_sentiment_aanalysis_tpu_torch.train.state import clip_by_global_norm

    model = tp_model(mesh2d, c, dropout=0.0)
    model.train()
    params = dict(model.named_parameters())
    stats = {k: v for k, v in model.named_buffers() if "running" in k}

    def loss_fn(p, s, b, generator):
        return full_objective(lambda *a, **kw: functional_call(model, {**p, **s}, a, kw), b,
                              generator), b["mask"].sum()[None]

    opt = torch.optim.SGD(list(params.values()), lr=1e-2)
    batch = _tensors(c["batch"])
    if mesh2d is not None:
        make_dp_train_step(loss_fn, opt, mesh2d, clip_norm=1.0)(params, stats, batch)
        return {"grads": whole_grads(model)}
    n, blocks = batch["mask"].sum(), c["dp"]
    rows = batch["mask"].shape[0] // blocks
    for i in range(blocks):
        b = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        loss, _ = loss_fn(params, {k: v.clone() for k, v in stats.items()}, b, None)
        (loss * b["mask"].sum() / n).backward()
    norm = clip_by_global_norm(params.values(), 1.0)
    return {"grads": whole_grads(model), "norm": norm}


def tp_gather_backward(mesh2d, c):
    """The model-axis gather's backward on its own: ``sum(gather(x) * w)``
    with ``w`` replicated gives each rank ``w``'s block, not a sum of the
    ranks' (which would be ``size`` times it)."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel.collectives import ModelAxis

    axis = ModelAxis(mesh2d.get_group(MODEL))
    x = (torch.arange(3.0) + 10.0 * axis.index).requires_grad_()
    w = torch.arange(3.0 * axis.size) + 1.0
    (axis.gather(x, 0) * w).sum().backward()
    return {"grad": x.grad, "block": w[3 * axis.index:3 * (axis.index + 1)]}


TP_CASES = {"roundtrip": tp_roundtrip, "eval": tp_eval, "step": tp_step, "clip": tp_clip,
            "gather_backward": tp_gather_backward}


def tp_cases(mesh, inputs: dict) -> dict:
    """Every ``(dp, tp)`` mesh of ``inputs`` whose ranks make up this
    launch's world, and each of its cases, in one launch: ``{(dp, tp, label):
    result}``."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel import make_mesh_2d

    torch.manual_seed(0)
    out = {}
    for (dp, tp), cases in inputs.items():
        if dp * tp != mesh.size():
            continue
        mesh2d = make_mesh_2d(dp, tp, device_type="cpu")
        for label, c in cases.items():
            out[(dp, tp, label)] = TP_CASES[c["case"]](mesh2d, c)
    return out
