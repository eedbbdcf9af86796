"""The port's subject sharding (``parallel/``) on the CPU, two ``gloo`` ranks.

The ranks start once for the module (``parallel.dryrun.spawn_ranks``, a
``FileStore`` in a temporary directory, a 60 s limit on every collective and
a limit on the launch): every two-rank case runs in that one launch
(``torch_parallel_ranks.w2_cases``), in a thread, beside the dry run's own
launch, while this process runs the JAX package and the port's one-process
runs they are held to. The models are tiny and dropout is 0 (each rank
draws its own dropout stream). Batch data parallelism is in
``test_torch_port_parallel_dp.py``.

- (a) subject-sharded ``VectorizedLOSOTrainer`` at W=2 against the JAX
  trainer on ``make_mesh(2)`` of the 8-device CPU mesh, 3 subjects (both pad
  to 4), from the JAX stacked init, 2 host-plan epochs: ``n_total``,
  ``train_idx`` and ``test_idx`` equal, accuracies equal, per-subject losses
  within 1e-6 relative, parameters within 1e-4 (JAX's own sharded-vs-
  unsharded bar, ``tests/test_vloso.py``), BatchNorm stats within 1e-5
  (measured on the CPU: losses 2.2e-7 relative, parameters 3.8e-6, stats
  7.0e-7; JAX's loss bar, 1e-5 absolute, is two float32 steps at these
  losses of ~70 and the gap reads 1.5e-5); and 4 subjects (no padding) at
  W=2 against the port's unsharded trainer at JAX's bars (losses 1e-5,
  parameters 1e-4);
- (b) the port at W=2 against the port unsharded: the phased trainer (one
  ``fusion_arousal`` epoch, 3 subjects, padded), the SimCLR trainer (one
  pretrain and one finetune epoch, 4 subjects), fused early-stop LOSO
  epochs (4 subjects): losses within 1e-5 relative, accuracies, stop epochs,
  learning-rate lanes and the stop report equal, parameters within 1e-5;
- (f) a W=2 ``save_state`` restored into an unsharded trainer of another
  seed resumes bit-equal to the W=2 run's next epoch;
- (g) ``dryrun_multichip(2)`` on the CPU, at flagship width.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import jax

from multimodal_sentiment_aanalysis_tpu import models as jmodels
from multimodal_sentiment_aanalysis_tpu.data import DeviceDataset as JaxDataset
from multimodal_sentiment_aanalysis_tpu.parallel import make_mesh as jax_make_mesh
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    state_dict_from_jax_variables,
    trainer_state_from_jax,
)
from multimodal_sentiment_aanalysis_tpu_torch.parallel import dryrun_multichip
from multimodal_sentiment_aanalysis_tpu_torch.parallel.dryrun import spawn_ranks
from multimodal_sentiment_aanalysis_tpu_torch.train import VectorizedLOSOTrainer
import torch_parallel_ranks as ranks
from torch_parallel_ranks import hci_arrays, random_arrays
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LAUNCH_LIMIT = 300.0  # seconds for a whole two-rank launch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank launch and the dry run, and meanwhile the JAX run and the
    port's one-process runs."""
    from multimodal_sentiment_aanalysis_tpu.train import VectorizedLOSOTrainer as JaxVLOSO

    tmp = str(tmp_path_factory.mktemp("parallel"))
    loso = dict(feat=16, t_eeg=16, n_subjects=3, ex_nums=8, batch=8, epochs=2,
                arrays=hci_arrays(3))
    jt = JaxVLOSO(jmodels.MultimodalTransformerModel(feat_dim=16, eeg_time=16, dropout=0.0),
                  JaxDataset(loso["arrays"]), 3, 8, batch_size=8, seed=0, mesh=jax_make_mesh(2))
    loso["init"], loso["cw"] = trainer_state_from_jax(_np(jt.params), _np(jt.batch_stats))
    inputs = {
        "loso_vs_jax": loso,
        "loso_fused_es": dict(feat=16, t_eeg=16, n_subjects=4, ex_nums=8, batch=8, epochs=3,
                              arrays=hci_arrays(4)),
        "phased": dict(feat=16, t_eeg=16, n_subjects=3, ex_nums=8, batch=8,
                       arrays=hci_arrays(3)),
        "simclr": dict(feat=32, t_eeg=64, n_subjects=4, ex_nums=8, batch=8,
                       arrays=random_arrays(32, 64, 0)),
        "loso_resume": dict(feat=16, t_eeg=16, n_subjects=4, ex_nums=8, batch=8,
                            arrays=hci_arrays(4), path=os.path.join(tmp, "w2_state.pt")),
    }
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        launch = pool.submit(spawn_ranks, ranks.w2_cases, 2, (inputs,),
                             device_type="cpu", timeout=LAUNCH_LIMIT,
                             collective_timeout=60.0)
        dry = pool.submit(dryrun_multichip, 2, device_type="cpu", timeout=LAUNCH_LIMIT)
        ref = {name: ranks.CASES[name](None, inputs[name])
               for name in ("loso_resume", "loso_fused_es", "phased", "simclr")}
        jax_loso = {"history": [jt.train_epoch() for _ in range(2)], "eval": jt.evaluate()}
        w2, lines = launch.result(), dry.result()
    return {"w2": w2, "ref": ref, "inputs": inputs, "jax_loso": jax_loso, "jt": jt,
            "dryrun": lines}


def _close_states(got: dict, want: dict, atol: float, label: str, noise=(), noise_atol=None):
    assert got.keys() >= {k for k in want if not k.endswith("num_batches_tracked")}, label
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = noise_atol if any(k.startswith(n) for n in noise) else atol
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w), rtol=0, atol=tol,
                                   err_msg=f"{label} {k}")


# ----------------------------------------------------------------------
# (a) subject-sharded LOSO against JAX's mesh trainer
def test_loso_tables_match_jax(runs):
    got, jt = runs["w2"][0]["loso_vs_jax"], runs["jt"]
    assert got["n_total"] == jt.n_total == 4
    np.testing.assert_array_equal(got["train_idx"], jt.train_idx)
    np.testing.assert_array_equal(got["test_idx"], jt.test_idx)
    for r in runs["w2"][1:]:  # every rank returns the global results
        np.testing.assert_array_equal(r["loso_vs_jax"]["history"][-1]["loss"],
                                      got["history"][-1]["loss"])


def test_loso_sharded_matches_jax_mesh(runs):
    got, want = runs["w2"][0]["loso_vs_jax"], runs["jax_loso"]
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g["a_acc"], w["a_acc"])
        np.testing.assert_array_equal(g["v_acc"], w["v_acc"])
    np.testing.assert_array_equal(got["eval"]["a_acc"], want["eval"]["a_acc"])
    jt = runs["jt"]
    for s, sd in enumerate(got["variables"]):
        want_sd = state_dict_from_jax_variables(_np(jax.tree.map(
            lambda x: x[s], {"params": jt.params["model"], "batch_stats": jt.batch_stats})))
        stats = [k for k in want_sd if "running" in k]
        _close_states(sd, {k: v for k, v in want_sd.items() if k not in stats}, 1e-4,
                      f"subject {s}")
        _close_states(sd, {k: want_sd[k] for k in stats}, 1e-5, f"subject {s}")


def test_loso_sharded_matches_unsharded(runs):
    """Two host-plan epochs of 4 subjects (no padding) at W=2 and unsharded,
    at JAX's own sharded-vs-unsharded bars."""
    got, ref = runs["w2"][0]["loso_resume"], runs["ref"]["loso_resume"]
    np.testing.assert_allclose(got["epoch2"]["loss"], ref["epoch2"]["loss"], rtol=0, atol=1e-5)
    for k in ("a_acc", "v_acc"):
        np.testing.assert_array_equal(got["epoch2"][k], ref["epoch2"][k])
    np.testing.assert_allclose(got["params"].numpy(), ref["params"].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["stats"].numpy(), ref["stats"].numpy(), rtol=0, atol=1e-4)


# ----------------------------------------------------------------------
# (b) the port at W=2 against the port unsharded
def test_fused_early_stop_sharded_matches_unsharded(runs):
    got, ref = runs["w2"][0]["loso_fused_es"], runs["ref"]["loso_fused_es"]
    assert got["fused"].keys() == ref["fused"].keys()
    for k in ("loss", "te_loss"):
        np.testing.assert_allclose(got["fused"][k], ref["fused"][k], rtol=1e-5, atol=0)
    for k in ("a_acc", "v_acc", "te_a_acc", "te_v_acc", "lr", "stopped"):
        np.testing.assert_array_equal(got["fused"][k], ref["fused"][k], err_msg=k)
    for k in ("best", "final"):
        np.testing.assert_array_equal(got[k]["a_acc"], ref[k]["a_acc"])
    assert got["report"] == ref["report"]
    for s, (g, w) in enumerate(zip(got["variables"], ref["variables"])):
        _close_states(g, w, 1e-5, f"subject {s}")


def test_phased_sharded_matches_unsharded(runs):
    got, ref = runs["w2"][0]["phased"], runs["ref"]["phased"]
    for split in ("train", "test"):
        for k in ("loss", "a_loss", "c_loss"):
            np.testing.assert_allclose(got["metrics"][split][k], ref["metrics"][split][k],
                                       rtol=1e-5, atol=0, err_msg=f"{split} {k}")
        for k in ("a_acc", "v_acc"):
            np.testing.assert_array_equal(got["metrics"][split][k], ref["metrics"][split][k])
    assert got["last"]["a_acc"].shape == (3,)
    for s, (g, w) in enumerate(zip(got["variables"], ref["variables"])):
        _close_states(g, w, 1e-5, f"subject {s}")


def test_simclr_sharded_matches_unsharded(runs):
    got, ref = runs["w2"][0]["simclr"], runs["ref"]["simclr"]
    np.testing.assert_allclose(got["pretrain"][0], ref["pretrain"][0], rtol=1e-5, atol=0)
    for k in ("a_acc", "v_acc"):
        np.testing.assert_array_equal(got["finetune"][k], ref["finetune"][k])
    for s, (g, w) in enumerate(zip(got["variables"], ref["variables"])):
        for part, (gp, wp) in enumerate(zip(g, w)):
            _close_states(gp, wp, 1e-5, f"subject {s} part {part}")


# ----------------------------------------------------------------------
# (f) a W=2 state file resumes in an unsharded trainer, (g) the dry run
def test_sharded_state_resumes_unsharded(runs):
    c, got = runs["inputs"]["loso_resume"], runs["w2"][0]["loso_resume"]
    pt = VectorizedLOSOTrainer(ranks.tiny_model(c["feat"], c["t_eeg"]),
                               ranks.DeviceDataset(c["arrays"], "cpu"), c["n_subjects"],
                               c["ex_nums"], batch_size=c["batch"], seed=7)
    pt.restore_state(c["path"])
    epoch2 = pt.train_epoch()
    for k, v in got["epoch2"].items():
        np.testing.assert_array_equal(epoch2[k], v, err_msg=k)
    assert torch.equal(pt.params, got["params"]) and torch.equal(pt.stats, got["stats"])


def test_dryrun_multichip_on_the_cpu(runs):
    assert [line.split(" — ")[0] for line in runs["dryrun"]] == [
        "dryrun_multichip(2): batch-DP OK", "dryrun_multichip(2): subject-sharded OK",
        "dryrun_multichip(2): tensor-parallel OK"]
    assert runs["dryrun"][2].startswith(
        "dryrun_multichip(2): tensor-parallel OK — (data=1, model=2) mesh, loss ")


@pytest.mark.parametrize("launch", ["spawn_ranks", "dryrun_multichip"])
def test_launchers_run_on_the_card_by_default(monkeypatch, launch):
    """Without ``device_type="cpu"`` the ranks go to the card; a machine
    without one refuses before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"spawn_ranks": lambda: spawn_ranks(ranks.w2_cases, 2, ({},)),
            "dryrun_multichip": lambda: dryrun_multichip(2)}[launch]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
