"""The port's tensor parallelism (``parallel/tp.py``) on the CPU, ``gloo`` ranks.

Two launches run once for the module, side by side in threads
(``parallel.dryrun.spawn_ranks``): two ranks for the ``(1, 2)`` mesh and
four for the ``(2, 2)`` and ``(1, 4)`` meshes, every case of a mesh in its
launch (``torch_parallel_ranks.tp_cases``), while this process runs the JAX
package and the port's one-process runs they are held to. The model is the
tiny flagship of JAX's own TP tests (feat_dim 32, eeg_time 64, B = 16),
its weights a seeded port init, which JAX loads through
``variables_from_torch_state_dict``.

- JAX's placement: the port's spec of every parameter equals JAX
  ``param_partition_specs`` of the flax leaf it imports from, at flagship
  width (142 leaves, 105 split at tp 2 and 4, none at 7);
- layout: shard then gather gives the ``state_dict`` back bit for bit, and
  every rank holds exactly its JAX block of each tensor;
- against JAX: the eval forward at ``(2, 2)`` and ``(1, 4)`` at JAX's atol
  2e-5, and JAX's SGD-on-CE step (``tests/test_parallel_tp.py``) at ``(2,
  2)`` against JAX's one-device step at its loss rtol 1e-5 and params atol
  1e-5, run in this process rather than through JAX's slow GSPMD test;
- against one process: the train-mode full objective (CE on both heads and
  the three InfoNCE terms, SGD 1e-2) at ``(1, 2)`` with dropout on (both
  model ranks draw one process's masks by construction) and at ``(2, 2)``
  with dropout 0, and the v5 BiLSTM schedule at ``(1, 2)``: the loss at
  1e-6 relative (measured: 6.3e-8 at most), each parameter's update at
  the data-parallel tests' gradient bar, 1e-5 of the tensor's largest
  update plus 1e-6 of the step's largest (an SGD update is the gradient
  times the rate; measured: 0.063 of the bar at most), each BatchNorm
  running stat at 1e-5
  of its largest entry (measured: 7.9e-7). A zero-initialised bias moves
  by its gradient alone, whose float noise is 1e-5 of its largest entry,
  so the parameters themselves are not held at 1e-6;
- a binding ``clip_norm=1.0`` step of ``make_dp_train_step`` (local
  semantics): the clipped gradients it steps with at ``(1, 2)`` at the
  same bar, and at ``(2, 2)`` at 1e-4 of each tensor's largest entry plus
  1e-6 of the step's: each data rank's 8-row block runs the trunk's
  batch-statistic BatchNorm backward, whose cancellation leaves 1.2e-5 of
  a tensor's largest gradient entry between the TP and the one-process run
  (measured on ``fusion.0.weight`` and ``valence_head.0.weight``), the clip
  norm agreeing to 6e-8;
- the replicated parameters bit-equal on the model ranks after two AdamW
  steps with dropout;
- the model-axis gather's backward keeps this rank's slice (a sum there
  makes every sharded gradient ``tp`` times too large);
- the stem tail's channel shard: ``keep_mask_plain`` and the CPU forward
  with a channel offset equal the unsharded layer's columns.
"""

import concurrent.futures

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from multimodal_sentiment_aanalysis_tpu import models as jmodels
from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
    variables_from_torch_state_dict,
)
from multimodal_sentiment_aanalysis_tpu.ops.losses import masked_cross_entropy as jax_ce
from multimodal_sentiment_aanalysis_tpu.parallel.tp import param_partition_specs as jax_specs
from multimodal_sentiment_aanalysis_tpu_torch import parallel
from multimodal_sentiment_aanalysis_tpu_torch.kernels import conv_stem_train
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MultimodalTransformerModel,
    state_dict_from_jax_variables,
)
from multimodal_sentiment_aanalysis_tpu_torch.parallel import param_partition_specs
from multimodal_sentiment_aanalysis_tpu_torch.parallel.dryrun import spawn_ranks
import torch_parallel_ranks as ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LAUNCH_LIMIT = 300.0  # seconds for a whole launch
FEAT, T_EEG, B = 32, 64, 16
LOSS_RTOL = 1e-6  # the port against one process
UPDATE_REL, UPDATE_TOP = 1e-5, 1e-6  # of each tensor's largest update, of the step's
STATS_REL = 1e-5  # BatchNorm running stats, of each tensor's largest entry
CLIP_2X2_REL = 1e-4  # 8-row blocks (module docstring)


def _batch() -> dict:
    """``tests/test_parallel_tp.py``'s batch."""
    rng = np.random.default_rng(0)
    return {"eeg": rng.normal(size=(B, 32, T_EEG)).astype(np.float32),
            "eye": rng.normal(size=(B, 38)).astype(np.float32),
            "pps": rng.normal(size=(B, 230)).astype(np.float32),
            "arousal": rng.integers(0, 3, B).astype(np.int64),
            "valence": rng.integers(0, 3, B).astype(np.int64),
            "mask": np.ones(B, np.float32)}


def _case(case: str, **kw) -> dict:
    return {"case": case, **kw}


@pytest.fixture(scope="module")
def runs():
    """The two launches, and meanwhile the JAX runs and the one-process
    runs."""
    model = MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG,
                                       generator=torch.Generator().manual_seed(0))
    base = {"feat": FEAT, "t_eeg": T_EEG, "state": model.state_dict(), "batch": _batch()}
    step = dict(base, objective="full", steps=1, seed=7)
    inputs = {
        (1, 2): {"roundtrip": _case("roundtrip", **base),
                 "dropout": _case("step", **dict(step, dropout=None)),
                 "replicated": _case("step", **dict(step, dropout=None, steps=2, adamw=True)),
                 "v5": _case("step", **dict(step, dropout=0.0, schedule="v5")),
                 "clip": _case("clip", **dict(base, dp=1)),
                 "gather_backward": _case("gather_backward")},
        (2, 2): {"roundtrip": _case("roundtrip", **base), "eval": _case("eval", **base),
                 "sgd_ce": _case("step", **dict(step, objective="ce", dropout=None)),
                 "full": _case("step", **dict(step, dropout=0.0)),
                 "clip": _case("clip", **dict(base, dp=2))},
        (1, 4): {"roundtrip": _case("roundtrip", **base), "eval": _case("eval", **base)},
    }
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        launches = [pool.submit(spawn_ranks, ranks.tp_cases, n, (inputs,), device_type="cpu",
                                timeout=LAUNCH_LIMIT, collective_timeout=60.0)
                    for n in (2, 4)]
        ref = {(mesh, label): ranks.TP_CASES[inputs[mesh][label]["case"]](None,
                                                                          inputs[mesh][label])
               for mesh, label in (((1, 2), "dropout"), ((1, 2), "v5"), ((2, 2), "full"),
                                   ((1, 2), "clip"), ((2, 2), "clip"))}
        jax_ref = _jax_runs(base)
        per_rank = [r for launch in launches for r in launch.result()]
    return {"ranks": per_rank, "ref": ref, "jax": jax_ref, "init": base["state"]}


def _jax_runs(base: dict) -> dict:
    """JAX's one-device eval forward and SGD-on-CE step
    (``tests/test_parallel_tp.py``) from the port's weights."""
    jm = jmodels.MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG)
    variables = jax.tree.map(jnp.asarray, variables_from_torch_state_dict(base["state"]))
    bs, batch = variables["batch_stats"], base["batch"]
    logits = jax.jit(lambda v, e, y, p: jm.apply(v, e, y, p))(
        variables, batch["eeg"], batch["eye"], batch["pps"])
    tx = optax.sgd(1e-2)

    def step_fn(params, b):
        def loss(p):
            outs = jm.apply({"params": p, "batch_stats": bs}, b["eeg"], b["eye"], b["pps"],
                            labels=(b["arousal"], b["valence"], b["mask"]), train=False)
            return jax_ce(outs[0], b["arousal"], b["mask"])

        value, grads = jax.value_and_grad(loss)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), value

    params, loss = jax.jit(step_fn)(variables["params"], batch)
    state = state_dict_from_jax_variables(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": bs}))
    return {"logits": [np.asarray(x) for x in logits], "loss": float(loss), "state": state}


def _rank_results(runs, mesh: tuple, label: str) -> list:
    """Every rank's result of one case, in rank order."""
    return [r[(*mesh, label)] for r in runs["ranks"] if (*mesh, label) in r]


def _close_grads(got: dict, want: dict, rel: float, label: str) -> None:
    """Each gradient within ``rel`` of its largest entry plus
    ``UPDATE_TOP`` of the step's largest."""
    assert got.keys() == want.keys(), label
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        bar = rel * float(w.abs().max()) + UPDATE_TOP * top
        assert float((got[k] - w).abs().max()) <= bar, f"{label} {k}"


def _close_step(got: dict, want: dict, init: dict, label: str) -> None:
    """A stepped ``state_dict`` against one process's: each parameter's
    update (from ``init``) within ``UPDATE_REL`` of the tensor's largest
    update plus ``UPDATE_TOP`` of the step's largest; each running stat
    within ``STATS_REL`` of its largest entry; the counters equal."""
    assert got.keys() == want.keys(), label
    updates = {k: w - init[k] for k, w in want.items()
               if w.is_floating_point() and "running" not in k}
    top = max(float(u.abs().max()) for u in updates.values())
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), f"{label} {k}"
        elif k in updates:
            bar = UPDATE_REL * float(updates[k].abs().max()) + UPDATE_TOP * top
            assert float((got[k] - w).abs().max()) <= bar, f"{label} {k}"
        else:
            bar = STATS_REL * float(w.abs().max())
            assert float((got[k] - w).abs().max()) <= bar, f"{label} {k}"


# ----------------------------------------------------------------------
# JAX's placement, and the names
@pytest.mark.parametrize("tp, n_split", [(2, 105), (4, 105), (7, 0)])
def test_specs_match_jax(tp, n_split):
    """Each port parameter's spec is JAX's spec of the flax leaf it imports
    from (found by filling leaf i with i), a Dense kernel's dims swapped."""
    jm = jmodels.MultimodalTransformerModel()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), np.zeros((2, 32, 585), np.float32),
                                            np.zeros((2, 38), np.float32),
                                            np.zeros((2, 230), np.float32)))
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes["params"])
    params = jax.tree_util.tree_unflatten(tree, [np.full(x.shape, i, np.float32)
                                                 for i, (_, x) in enumerate(leaves)])
    stats = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), shapes["batch_stats"])
    sd = state_dict_from_jax_variables({"params": params, "batch_stats": stats})
    specs = jax.tree_util.tree_leaves(jax_specs(shapes["params"], tp),
                                      is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(specs) == 142
    assert sum(s != P() for s in specs) == n_split
    port = param_partition_specs(MultimodalTransformerModel(), tp)
    assert len(port) == 142 and sum(s != () for s in port.values()) == n_split
    for name, spec in port.items():
        i = int(sd[name].reshape(-1)[0])
        want = tuple(specs[i])
        if jax.tree_util.keystr(leaves[i][0]).endswith("['kernel']"):
            want = want[::-1]
        assert spec == want, name


def test_specs_at_tp_1_replicate_everything():
    assert set(param_partition_specs(MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG),
                                     1).values()) == {()}


def test_tp_names_are_exported():
    """The four names of JAX ``parallel/tp.py`` (and the gathering inverse)
    come from the port's ``parallel/tp.py``, no longer a refusal."""
    from multimodal_sentiment_aanalysis_tpu_torch.parallel import tp

    for name in ("make_mesh_2d", "param_partition_specs", "shard_by_specs", "batch_sharding",
                 "gather_state_dict"):
        assert getattr(parallel, name) is getattr(tp, name)
        assert name in parallel.__all__


def test_make_mesh_2d_needs_the_world_size():
    """A one-rank group in this process: (1, 1) is its mesh, (2, 1) and (1, 2)
    raise."""
    mesh = parallel.make_mesh_2d(1, 1, device_type="cpu")
    try:
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        for dp, tp in ((2, 1), (1, 2)):
            with pytest.raises(ValueError, match="ranks"):
                parallel.make_mesh_2d(dp, tp, device_type="cpu")
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the stem tail on a channel shard
@pytest.mark.parametrize("shape, tp", [((2, 12, 64), 2), ((2, 9, 32), 4), ((2, 3, 6, 16), 2)])
def test_keep_mask_channel_shard(shape, tp):
    """Each shard's keep bits are the unsharded mask's columns."""
    seeds = torch.tensor([2 ** 40 + 7, 12345][:len(shape) - 2], dtype=torch.int64)
    whole = conv_stem_train.keep_mask_plain(seeds, shape, 0.4)
    c = shape[-1] // tp
    for i in range(tp):
        shard = conv_stem_train.keep_mask_plain(seeds, (*shape[:-1], c), 0.4,
                                                channels=(i * c, shape[-1]))
        assert torch.equal(shard, whole[..., i * c:(i + 1) * c])
    assert torch.equal(conv_stem_train.keep_mask_plain(seeds, shape, 0.4,
                                                       channels=(0, shape[-1])), whole)


@pytest.mark.parametrize("p", [0.0, 0.4])
def test_stem_tail_channel_shard_on_the_cpu(p):
    """The CPU forward of a shard draws the layer's whole block of the
    stream and equals the unsharded output's columns, codes included."""
    rng = np.random.default_rng(1)
    conv = torch.from_numpy(rng.normal(size=(3, 20, 16)).astype(np.float32))
    gamma, beta = torch.rand(16) + 0.5, torch.randn(16)
    mean, var = conv.mean((0, 1)), conv.var((0, 1))
    whole = conv_stem_train.stem_tail_fwd(conv, gamma, beta, mean, var, p, 4,
                                          generator=torch.Generator().manual_seed(3))
    for i in range(2):
        cols = slice(8 * i, 8 * (i + 1))
        shard = conv_stem_train.stem_tail_fwd(conv[..., cols], gamma[cols], beta[cols],
                                              mean[cols], var[cols], p, 4,
                                              generator=torch.Generator().manual_seed(3),
                                              channels=(8 * i, 16))
        for got, want in zip(shard, whole):
            assert torch.equal(got, want[..., cols])
    with pytest.raises(ValueError, match="does not fit"):
        conv_stem_train.stem_tail_fwd(conv[..., :8], gamma[:8], beta[:8], mean[:8], var[:8],
                                      p, 4, channels=(12, 16))


# ----------------------------------------------------------------------
# layout
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)])
def test_shard_then_gather_round_trip(runs, mesh):
    for r in _rank_results(runs, mesh, "roundtrip"):
        assert r["gathered"]


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)])
def test_each_rank_stores_its_jax_shard(runs, mesh):
    results = _rank_results(runs, mesh, "roundtrip")
    assert len(results) == mesh[0] * mesh[1]
    for r in results:
        assert all(r["blocks"].values()), [k for k, ok in r["blocks"].items() if not ok]


# ----------------------------------------------------------------------
# against JAX
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_eval_forward_matches_jax(runs, mesh):
    """The data blocks' logits, in data order, at JAX's atol 2e-5."""
    dp, tp = mesh
    results = _rank_results(runs, mesh, "eval")
    for head in range(2):
        for m in range(tp):  # every model rank of a data row holds the whole logits
            got = torch.cat([results[d * tp + m]["logits"][head] for d in range(dp)])
            np.testing.assert_allclose(got.numpy(), runs["jax"]["logits"][head], rtol=0,
                                       atol=2e-5)


def test_sgd_ce_step_matches_jax(runs):
    """JAX's SGD-on-CE step (eval mode) on the (2, 2) mesh against JAX's one
    device: the loss at rtol 1e-5, every parameter at atol 1e-5."""
    want = runs["jax"]
    for r in _rank_results(runs, (2, 2), "sgd_ce"):
        np.testing.assert_allclose(float(r["loss"][0]), want["loss"], rtol=1e-5)
        for k, w in want["state"].items():
            if "running" in k or k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(r["state"][k].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


# ----------------------------------------------------------------------
# against one process
@pytest.mark.parametrize("mesh, label", [((1, 2), "dropout"), ((2, 2), "full"), ((1, 2), "v5")])
def test_train_step_matches_one_process(runs, mesh, label):
    """The full objective in train mode, one SGD step (module docstring's
    bars); at (1, 2) with the model's own dropout."""
    want = runs["ref"][(mesh, label)]
    for r in _rank_results(runs, mesh, label):
        np.testing.assert_allclose(r["loss"].numpy(), want["loss"].numpy(), rtol=LOSS_RTOL,
                                   atol=0)
        _close_step(r["state"], want["state"], runs["init"], label)


@pytest.mark.parametrize("mesh, rel", [((1, 2), UPDATE_REL), ((2, 2), CLIP_2X2_REL)])
def test_clip_step_matches_one_process(runs, mesh, rel):
    """``make_dp_train_step(clip_norm=1.0)`` on a 2-D mesh: the clip binds,
    and its norm is the whole parameter vector's (a norm of this rank's
    shards alone would clip by another factor): the clipped gradients."""
    want = runs["ref"][(mesh, "clip")]
    assert float(want["norm"]) > 1.0
    for r in _rank_results(runs, mesh, "clip"):
        _close_grads(r["grads"], want["grads"], rel, f"clip {mesh}")


def test_replicated_parameters_bit_equal(runs):
    """After two AdamW steps with dropout, each replicated parameter is the
    same on both model ranks, bit for bit."""
    a, b = (r["replicated"] for r in _rank_results(runs, (1, 2), "replicated"))
    assert a.keys() == b.keys() and len(a) == 142 - 105
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_gather_backward_takes_the_slice(runs):
    for r in _rank_results(runs, (1, 2), "gather_backward"):
        assert torch.equal(r["grad"], r["block"])
