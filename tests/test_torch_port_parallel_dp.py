"""The port's batch data parallelism (``parallel/``) on the CPU, two ``gloo`` ranks.

The ranks start once for the module, as in ``test_torch_port_parallel.py``
(subject sharding), and run every two-rank case in one launch while this
process runs the JAX package and the port's one-process runs. The models
are tiny and dropout is 0 (each rank draws its own dropout stream).

- (c) ``MultiTaskTrainer(mesh=)`` at W=2 against the JAX trainer on
  ``make_mesh(2)`` (JAX's shape: feat_dim 32, eeg_time 64, 40 train rows at
  B=16, so one rank's block of the tail batch is all padding),
  ``fusion_arousal`` then ``valence`` from the JAX init: losses within 1e-3,
  parameters within JAX's 1e-4 and 2e-4 outside the biases before a
  BatchNorm (exact gradient 0, Adam moves them by +-lr on float noise, in
  each package its own way); and the summed gradients of one ``eeg`` and one
  ``fusion_arousal`` step against the one-process step's (1e-5 of each
  tensor's largest entry plus 1e-6 of the step's largest: a conv bias
  before a BatchNorm has a gradient of float noise), which fails if the
  stem tail's backward returns the global dgamma (that gradient would come
  out W-fold);
- (d) ``make_dp_train_step`` / ``make_dp_eval_step`` against JAX's on the
  8-device mesh (JAX's deterministic CE loss in eval mode, SGD): parameters
  within 1e-5, the eval sums at JAX's bars; ``pad_batch_to_devices``
  exactly;
- (e) ``global_batch_step`` (the ``gspmd_jit_step`` counterpart, train mode,
  the full objective with the gathered InfoNCE) against the one-process step:
  loss within 1e-5 relative, parameters and BatchNorm stats within 1e-5.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax

from multimodal_sentiment_aanalysis_tpu import models as jmodels
from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
from multimodal_sentiment_aanalysis_tpu.parallel import make_mesh as jax_make_mesh
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    phased_state_from_jax,
    state_dict_from_jax_variables,
)
from multimodal_sentiment_aanalysis_tpu_torch.parallel import pad_batch_to_devices
from multimodal_sentiment_aanalysis_tpu_torch.parallel.dryrun import spawn_ranks
import torch_parallel_ranks as ranks
from torch_parallel_ranks import random_arrays
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LR = 1e-4
# the biases before a BatchNorm: their exact gradient is 0, and Adam moves
# them by about +-lr on float noise, each package its own way
BN_NOISE = ("eeg_net.temp_conv.0.bias", "eeg_net.temp_conv.5.bias", "fusion.0.bias",
            "fusion.4.bias", "arousal_head.0.bias", "valence_head.0.bias", "valence_head.4.bias",
            "valence_head.8.bias", "valence_head.12.bias")
LAUNCH_LIMIT = 300.0  # seconds for the whole two-rank launch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    """The two-rank launch, and meanwhile the JAX runs and the port's
    one-process runs."""
    from multimodal_sentiment_aanalysis_tpu.train import MultiTaskTrainer as JaxMTT

    mt_arrays = random_arrays(48, 64, 3)
    mt = dict(feat=32, t_eeg=64, batch=16, train={k: v[:40] for k, v in mt_arrays.items()},
              test={k: v[40:] for k, v in mt_arrays.items()})
    jmt = JaxMTT(jmodels.MultimodalTransformerModel(feat_dim=32, eeg_time=64, dropout=0.0),
                 JaxDataset(mt["train"]), JaxDataset(mt["test"]), batch_size=16, seed=5,
                 verbose=False, mesh=jax_make_mesh(2))
    mt["init"] = phased_state_from_jax(_np(jmt.params), _np(jmt.batch_stats))

    dp_batch = {**random_arrays(32, 64, 0), "mask": np.ones(32, np.float32)}
    jmodel = jmodels.MultimodalTransformerModel(feat_dim=32, eeg_time=64)
    jvars = jmodel.init(jax.random.key(0), dp_batch["eeg"][:2], dp_batch["eye"][:2],
                        dp_batch["pps"][:2])
    inputs = {
        "multitask_vs_jax": mt,
        # a batch with 3 padded rows, all in rank 1's block
        "multitask_grads": {**mt, "valid": 13},
        "dp_steps": dict(feat=32, t_eeg=64, batch=dp_batch,
                         init=state_dict_from_jax_variables(_np(jvars))),
        "global_step": dict(feat=16, t_eeg=16, init=ranks.tiny_model(16, 16).state_dict(),
                            batch={**random_arrays(24, 16, 7),
                                   "mask": (np.arange(24) < 21).astype(np.float32)}),
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launch = pool.submit(spawn_ranks, ranks.w2_cases, 2, (inputs,),
                             device_type="cpu", timeout=LAUNCH_LIMIT,
                             collective_timeout=60.0)
        ref = {name: ranks.CASES[name](None, inputs[name])
               for name in ("multitask_grads", "global_step")}
        jax_mt = {}
        for phase in ("fusion_arousal", "valence"):
            metrics = jmt.train_epoch_phase(phase)
            jax_mt[phase] = (metrics, state_dict_from_jax_variables(
                {"params": _np(jmt.params), "batch_stats": _np(jmt.batch_stats)}))
        jax_dp = _jax_dp_steps(jmodel, jvars, dp_batch)
        w2 = launch.result()
    return {"w2": w2, "ref": ref, "jax_mt": jax_mt, "jax_dp": jax_dp}


def _jax_dp_steps(model, variables, batch):
    """JAX ``tests/test_parallel.py``'s deterministic CE step and eval on the
    8-device mesh."""
    import optax

    from multimodal_sentiment_aanalysis_tpu.ops.losses import (
        masked_accuracy,
        masked_cross_entropy,
    )
    from multimodal_sentiment_aanalysis_tpu.parallel import (
        make_dp_train_step,
        replicate,
        shard_batch,
    )
    from multimodal_sentiment_aanalysis_tpu.parallel.dp import make_dp_eval_step

    mesh = jax_make_mesh(8)

    def det_loss(params, batch_stats, b, key):
        outs = model.apply({"params": params, "batch_stats": batch_stats},
                           b["eeg"], b["eye"], b["pps"],
                           labels=(b["arousal"], b["valence"], b["mask"]), train=False)
        return (masked_cross_entropy(outs[0], b["arousal"], b["mask"]),
                (batch_stats, {"n": b["mask"].sum()}))

    tx = optax.sgd(1e-2)
    step = make_dp_train_step(det_loss, tx, mesh, clip_norm=None)
    params, *_ = step(replicate(mesh, variables["params"]),
                      replicate(mesh, variables["batch_stats"]),
                      replicate(mesh, tx.init(variables["params"])), jax.random.key(0),
                      shard_batch(mesh, batch))

    def metrics_fn(params, batch_stats, b):
        a, _ = model.apply({"params": params, "batch_stats": batch_stats},
                           b["eeg"], b["eye"], b["pps"])
        n = b["mask"].sum()
        return {"a_acc": masked_accuracy(a, b["arousal"], b["mask"]) * n,
                "loss": masked_cross_entropy(a, b["arousal"], b["mask"]) * n, "n": n}

    ev = make_dp_eval_step(metrics_fn, mesh)(variables["params"], variables["batch_stats"],
                                             shard_batch(mesh, batch))
    stepped = state_dict_from_jax_variables({"params": _np(params),
                                             "batch_stats": _np(variables["batch_stats"])})
    return {"params": stepped, "eval": _np(ev)}


def _close_states(got: dict, want: dict, atol: float, label: str, noise=(), noise_atol=None):
    assert got.keys() >= {k for k in want if not k.endswith("num_batches_tracked")}, label
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = noise_atol if any(k.startswith(n) for n in noise) else atol
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w), rtol=0, atol=tol,
                                   err_msg=f"{label} {k}")


# ----------------------------------------------------------------------
# (c) batch DP of MultiTaskTrainer against JAX's GSPMD trainer
def test_multitask_dp_matches_jax_mesh(runs):
    got, want = runs["w2"][0]["multitask_vs_jax"], runs["jax_mt"]
    for phase, bar in (("fusion_arousal", 1e-4), ("valence", 2e-4)):
        g_metrics, g_state = got[phase]
        w_metrics, w_state = want[phase]
        assert abs(g_metrics["loss"] - w_metrics["loss"]) < 1e-3, (phase, g_metrics, w_metrics)
        assert g_metrics["a_acc"] == w_metrics["a_acc"]
        params = {k: v for k, v in w_state.items() if "running" not in k}
        _close_states(g_state, params, bar, phase, noise=BN_NOISE, noise_atol=5 * LR)
    for r in runs["w2"][1:]:  # the parameters stay replicated
        for k, v in r["multitask_vs_jax"]["valence"][1].items():
            assert torch.equal(v, got["valence"][1][k]), k


@pytest.mark.parametrize("phase", ["eeg", "fusion_arousal"])
def test_multitask_dp_gradients_are_the_global_batch(runs, phase):
    """The summed gradients equal the one-process step's; a stem tail whose
    backward returned the global dgamma would make the stem's BN weight
    gradient W-fold."""
    g_sums, g_grads = runs["w2"][0]["multitask_grads"][phase]
    r_sums, r_grads = runs["ref"]["multitask_grads"][phase]
    np.testing.assert_allclose(g_sums.numpy(), r_sums.numpy(), rtol=1e-5, atol=1e-6)
    assert g_grads.keys() == r_grads.keys()
    assert "eeg_net.temp_conv.1.weight" in g_grads
    top = max(float(r.abs().max()) for r in r_grads.values())
    for k, r in r_grads.items():
        np.testing.assert_allclose(g_grads[k].numpy(), r.numpy(), rtol=0,
                                   atol=1e-5 * float(r.abs().max()) + 1e-6 * top,
                                   err_msg=f"{phase} {k}")


# ----------------------------------------------------------------------
# (d) the shard_map form against JAX's, (e) the GSPMD form
def test_dp_train_and_eval_steps_match_jax(runs):
    got, want = runs["w2"][0]["dp_steps"], runs["jax_dp"]
    assert float(got["n"][0]) == 32.0
    _close_states(got["params"], {k: v for k, v in want["params"].items()
                                  if "running" not in k}, 1e-5, "dp step")
    assert float(got["eval"]["n"]) == float(want["eval"]["n"])
    np.testing.assert_allclose(float(got["eval"]["a_acc"]), float(want["eval"]["a_acc"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["eval"]["loss"]), float(want["eval"]["loss"]),
                               rtol=1e-4)


def test_pad_batch_to_devices_matches_jax():
    import jax.numpy as jnp

    from multimodal_sentiment_aanalysis_tpu.parallel import pad_batch_to_devices as jax_pad

    batch = {"x": np.arange(10.0, dtype=np.float32), "y": np.arange(20).reshape(10, 2)}
    for n in (8, 5, 3):
        jb, jm = jax_pad({k: jnp.asarray(v) for k, v in batch.items()}, jnp.ones(10), n)
        pb, pm = pad_batch_to_devices({k: torch.from_numpy(v) for k, v in batch.items()},
                                      torch.ones(10), n)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        for k in batch:
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))


def test_global_batch_step_matches_one_process(runs):
    got, ref = runs["w2"][0]["global_step"], runs["ref"]["global_step"]
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-5)
    _close_states(got["state"], ref["state"], 1e-5, "global step")
