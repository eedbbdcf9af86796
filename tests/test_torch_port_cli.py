"""The port's command-line drivers on the CPU (``--device cpu --tiny``):

- the seven subparsers take the JAX ``cli.py``'s options (dest, flags,
  default, nargs, type, choices, action), less the TPU-only ``--platform``,
  ``--no-compile-cache`` and ``--preflight`` (and ``export``'s
  ``--platforms``), plus ``--device``;
- ``_load_arrays`` bit-equal to JAX's for ``--synthetic``, ``--tiny`` and
  ``--tiny --data``;
- each training subcommand's ``--results-json`` holds the JAX payload's keys
  (``JAX_KEYS``, read from the JAX ``cli.py`` lines named there) and equals,
  exactly, what the port's library gives for the same seed called as the
  subcommand calls it; ``vloso --save-state`` then ``--resume`` too;
- ``phased`` from a ``--data`` pickle of the synthetic dict equals
  ``phased --synthetic``, and its history CSV has the JAX config's columns;
- a ``phased`` checkpoint through ``eval`` gives the same accuracies in the
  port's CLI, the port's ``Tester`` and the JAX CLI's ``eval --tiny`` (the
  one JAX CLI run here);
- ``--dp`` without ``torchrun`` (a one-rank mesh) gives the run's results
  without it; ``--device cuda`` without a card and plots without
  matplotlib raise before any work;
- ``export`` (polymorphic, ``--batch-size 4``, ``--bf16``): the payload's
  byte count is the file's size, and the artifact serves batch 5 (4 for the
  fixed one) with the logits of ``build_serving_forward`` on the seeded
  flagship; with ``--model-path`` a saved state_dict's logits;
- in a subprocess with ``jax``, the JAX package, ``yaml``, ``sklearn`` and
  ``matplotlib`` made unimportable, ``main(["inspect", "--tiny", "--device",
  "cpu"])`` runs.
"""

import argparse
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu import cli as jcli
from multimodal_sentiment_aanalysis_tpu import config as jconfig
from multimodal_sentiment_aanalysis_tpu_torch import cli
from multimodal_sentiment_aanalysis_tpu_torch.data import (
    DeviceDataset,
    assemble_features,
    build_contrastive_pairs,
    loso_split,
    make_synthetic_emotion_arrays,
    make_synthetic_hci_data,
    random_split_indices,
    save_pickle,
    subject_ids_array,
)
from multimodal_sentiment_aanalysis_tpu_torch.eval import Tester as PortTester
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    Classifier,
    MEMHACLClassifier,
    MEMHACLEncoder,
    MultiModalEncoder,
    MultimodalTransformerModel,
    ProjectionHead,
)
from multimodal_sentiment_aanalysis_tpu_torch.train import (
    MultiTaskTrainer,
    Trainer,
    VectorizedLOSOTrainer,
    VectorizedPhasedTrainer,
    VectorizedSimCLRTrainer,
    contrastive_pretrain,
    finetune,
    memhacl_finetune,
    memhacl_pretrain,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SEED, N_SUBJECTS, EX_NUMS, FEAT, T_EEG = 42, 3, 8, 32, 64  # --tiny
CPU = torch.device("cpu")
TPU_ONLY = {"platform", "no_compile_cache", "preflight", "platforms"}
# the keys of each JAX payload (JAX cli.py lines); per-subject dicts keyed
# by the subject's index as a string
METRICS = {"loss", "a_loss", "v_loss", "c_loss", "a_acc", "v_acc"}  # MultiTaskTrainer.evaluate
JAX_KEYS = {
    "vloso": {"mean_arousal_acc", "mean_valence_acc", "per_subject_arousal",  # :422-431
              "per_subject_valence", "stop_epochs", "final_arousal_acc", "final_valence_acc"},
    "single": {"per_subject", "mean_arousal_acc"},                            # :387-388
    "phased": {"per_subject", "mean_arousal_acc", "mean_valence_acc"},        # :181-182
    "simclr": {"per_subject", "mean_arousal_acc", "mean_valence_acc"},        # :356-357
    "memhacl": {"a_acc", "v_acc", "loss_history"},                            # :476
    "eval": {"arousal_accuracy", "valence_accuracy"},                         # :493-496
}
PER_SUBJECT_KEYS = {"single": {"test_acc", "test_loss"}, "phased": METRICS,   # :382-383, :130
                    "phased_vectorized": {"a_acc", "v_acc"},                  # :271-274
                    "simclr": {"a_acc", "v_acc", "loss_history"},             # :343-348
                    "simclr_vectorized": {"a_acc", "v_acc"}}                  # :320-321


class _Captured(Exception):
    pass


def _raise_parser(self, *args, **kwargs):
    raise _Captured(self)


def subparsers(parser: argparse.ArgumentParser) -> dict:
    return dict(parser._subparsers._group_actions[0].choices)


def options(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices, a.required,
                     a.const, a.metavar, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


@pytest.fixture(scope="module")
def jax_parser() -> argparse.ArgumentParser:
    """The parser the JAX ``main`` builds, caught at ``parse_args``."""
    with mock.patch.object(argparse.ArgumentParser, "parse_args", _raise_parser):
        with pytest.raises(_Captured) as caught:
            jcli.main([])
    return caught.value.args[0]


def run(tmp_path, name: str, *argv: str) -> dict:
    """``cli.main`` on the CPU at --tiny; returns the results JSON."""
    out = tmp_path / f"{name}.json"
    cli.main([*argv, "--tiny", "--device", "cpu", "--quiet", "--no-plots",
              "--checkpoint-dir", str(tmp_path / f"ckpt_{name}"), "--results-json", str(out)])
    with open(out) as f:
        return json.load(f)


def tiny_arrays() -> dict:
    data = make_synthetic_hci_data(seed=SEED, n_subjects=N_SUBJECTS, ex_nums=EX_NUMS)
    feats, _ = assemble_features(data, ["eeg", "eye", "pps"])
    return {"eeg": np.ascontiguousarray(feats["eeg"][:, :, :T_EEG].astype(np.float32)),
            "eye": feats["eye"].astype(np.float32), "pps": feats["pps"].astype(np.float32),
            "arousal": np.asarray(data["arousal_label"]).astype(np.int64),
            "valence": np.asarray(data["valence_label"]).astype(np.int64)}


def flagship(seed: int) -> MultimodalTransformerModel:
    return MultimodalTransformerModel(feat_dim=FEAT, eeg_time=T_EEG, device=CPU,
                                      generator=torch.Generator().manual_seed(seed))


def generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def plain(value):
    """A library result as the JSON holds it."""
    return json.loads(json.dumps(cli._plain(value)))


# ---------------------------------------------------------------------------
# the parser and the data
# ---------------------------------------------------------------------------

def test_subcommands_are_jax_s_but_export(jax_parser):
    """Every JAX subcommand, ``export`` too since it was ported."""
    assert set(subparsers(cli.build_parser())) == set(subparsers(jax_parser))


@pytest.mark.parametrize("command", ["inspect", "vloso", "single", "phased", "simclr",
                                     "memhacl", "eval", "export"])
def test_options_match_jax(jax_parser, command):
    got = options(subparsers(cli.build_parser())[command])
    want = {k: v for k, v in options(subparsers(jax_parser)[command]).items()
            if k not in TPU_ONLY}
    device = got.pop("device")
    assert got == want
    assert device[:2] == (("--device",), "cuda") and device[4] == ("cuda", "cpu")


@pytest.mark.parametrize("flags", [("--synthetic",), ("--tiny",), ("--tiny", "--data")])
def test_load_arrays_matches_jax(tmp_path, flags):
    path = None
    if "--data" in flags:
        path = str(tmp_path / "tiny.pkl")
        save_pickle(make_synthetic_hci_data(seed=SEED, n_subjects=N_SUBJECTS, ex_nums=EX_NUMS),
                    path)
    ns = lambda: argparse.Namespace(tiny="--tiny" in flags, synthetic="--synthetic" in flags,
                                    data=path, seed=SEED, ex_nums=20)
    got, got_ex = cli._load_arrays(ns())
    want, want_ex = jcli._load_arrays(ns())
    assert got_ex == want_ex and got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_inspect(capsys):
    cli.main(["inspect", "--tiny", "--device", "cpu", "--batch-size", "16"])
    out = capsys.readouterr().out
    assert "eeg:     (16, 32, 64)" in out and "eye:     (16, 38)" in out
    assert "samples: 24 (3 subjects x 8 trials) on cpu" in out and "finite-check: OK" in out


def test_plain_payload():
    got = cli._plain({"a": np.float32(0.5), "b": [np.int64(3), np.arange(2)],
                      "c": torch.tensor([0.25]), 4: (np.bool_(True), None)})
    assert got == {"a": 0.5, "b": [3, [0, 1]], "c": [0.25], "4": [True, None]}
    assert type(got["a"]) is float and type(got["b"][0]) is int and type(got["4"][0]) is bool


# ---------------------------------------------------------------------------
# each subcommand against the library
# ---------------------------------------------------------------------------

def test_vloso_matches_library(tmp_path):
    state = str(tmp_path / "vloso.pt")
    got = run(tmp_path, "vloso", "vloso", "--epochs", "2", "--fused", "--early-stop",
              "--save-state", state)
    resumed = run(tmp_path, "vloso_resume", "vloso", "--epochs", "1", "--fused", "--early-stop",
                  "--resume", state)
    assert set(got) == set(resumed) == JAX_KEYS["vloso"]

    def trainer():
        return VectorizedLOSOTrainer(flagship(SEED), DeviceDataset(tiny_arrays(), CPU),
                                     N_SUBJECTS, EX_NUMS, seed=SEED, batch_size=64,
                                     early_stop=True, es_patience=5)

    vt = trainer()
    res = vt.run(2, verbose=False, fused=True)
    lib_state = vt.save_state(str(tmp_path / "lib.pt"))
    vt2 = trainer()
    vt2.restore_state(lib_state)
    res2 = vt2.run(1, verbose=False, fused=True)
    for payload, r in ((got, res), (resumed, res2)):
        assert payload == plain({k: r[k] for k in JAX_KEYS["vloso"]})
        assert all(0.0 <= a <= 1.0 for a in payload["per_subject_arousal"])


def test_single_matches_library(tmp_path):
    got = run(tmp_path, "single", "single", "--subjects", "0", "--epochs", "1")
    assert set(got) == JAX_KEYS["single"] and set(got["per_subject"]["0"]) == \
        PER_SUBJECT_KEYS["single"]
    full = DeviceDataset(tiny_arrays(), CPU)
    tr, te = loso_split(N_SUBJECTS, EX_NUMS, 0)
    t = Trainer(flagship(SEED), full.subset(tr), full.subset(te),
                checkpoint_dir=str(tmp_path / "lib"), seed=SEED, verbose=False)
    t.run(1, test_person=0)
    assert got == plain({"per_subject": {"0": {"test_acc": t.test_acc[-1],
                                               "test_loss": t.test_loss[-1]}},
                         "mean_arousal_acc": t.test_acc[-1]})


@pytest.fixture(scope="module")
def phased_run(tmp_path_factory):
    """``phased --subjects 0 --epochs 1 0 0 1 0 --history-dir`` on the
    synthetic set; returns its payload and directory."""
    tmp = tmp_path_factory.mktemp("phased")
    payload = run(tmp, "phased", "phased", "--synthetic", "--subjects", "0",
                  "--epochs", "1", "0", "0", "1", "0", "--history-dir", str(tmp / "history"))
    return payload, tmp


def test_phased_matches_library(phased_run, tmp_path):
    got, tmp = phased_run
    assert set(got) == JAX_KEYS["phased"] and set(got["per_subject"]["0"]) == \
        PER_SUBJECT_KEYS["phased"]
    full = DeviceDataset(tiny_arrays(), CPU)
    tr, te = loso_split(N_SUBJECTS, EX_NUMS, 0)
    mt = MultiTaskTrainer(flagship(SEED), full.subset(tr), full.subset(te), test_person=0,
                          checkpoint_dir=str(tmp_path), seed=SEED, verbose=False)
    final = mt.run(1, 0, 0, 1, 0, save=True, plot=False)
    assert got == plain({"per_subject": {"0": final}, "mean_arousal_acc": final["a_acc"],
                         "mean_valence_acc": final["v_acc"]})
    # the checkpoint is the library's, by name and by value
    (name,) = os.listdir(tmp / "ckpt_phased")
    assert os.listdir(tmp_path) == [name]
    saved = torch.load(tmp / "ckpt_phased" / name, weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in mt.model.state_dict().items())
    # the history CSV's columns: the timestamp, the JAX config's, subject 0, the summary
    import pandas as pd

    (csv,) = os.listdir(tmp / "history")
    columns = list(pd.read_csv(tmp / "history" / csv).columns)
    flat = list(jconfig.flatten_config(jconfig.Config()))
    assert columns == ["timestamp", *flat, "0", "Acc/Std", "F1/Std", "cm"]


def test_phased_from_a_data_pickle_equals_synthetic(phased_run, tmp_path):
    path = str(tmp_path / "hci.pkl")
    save_pickle(make_synthetic_hci_data(seed=SEED, n_subjects=N_SUBJECTS, ex_nums=EX_NUMS), path)
    got = run(tmp_path, "phased_data", "phased", "--data", path, "--subjects", "0",
              "--epochs", "1", "0", "0", "1", "0")
    assert got == phased_run[0]


def test_eval_of_a_phased_checkpoint_matches_jax_cli(phased_run, tmp_path):
    _, tmp = phased_run
    (name,) = os.listdir(tmp / "ckpt_phased")
    path = str(tmp / "ckpt_phased" / name)
    got = run(tmp_path, "eval", "eval", "--subjects", "0", "--model-path", path)
    assert set(got) == JAX_KEYS["eval"]
    full = DeviceDataset(tiny_arrays(), CPU)
    r = PortTester(flagship(SEED), full.subset(loso_split(N_SUBJECTS, EX_NUMS, 0)[1])).run(
        model_path=path, verbose=False)
    assert got == {"arousal_accuracy": r["arousal"]["accuracy"],
                   "valence_accuracy": r["valence"]["accuracy"]}
    out = tmp_path / "jax_eval.json"
    os.makedirs(tmp_path / "jax")  # the JAX eval writes its figures there
    jcli.main(["eval", "--tiny", "--subjects", "0", "--model-path", path, "--no-compile-cache",
               "--checkpoint-dir", str(tmp_path / "jax"), "--results-json", str(out)])
    with open(out) as f:
        assert json.load(f) == got


def test_phased_vectorized_matches_library(tmp_path):
    got = run(tmp_path, "vphased", "phased", "--vectorized", "--epochs", "1", "1", "1", "1", "1",
              "--history-dir", str(tmp_path / "history"))
    assert set(got) == JAX_KEYS["phased"]
    assert all(set(v) == PER_SUBJECT_KEYS["phased_vectorized"]
               for v in got["per_subject"].values())
    vp = VectorizedPhasedTrainer(flagship(SEED), DeviceDataset(tiny_arrays(), CPU), N_SUBJECTS,
                                 EX_NUMS, seed=SEED, verbose=False)
    res = vp.run(1, 1, 1, 1, 1)
    assert got == plain({"per_subject": {str(s): {"a_acc": res["per_subject_arousal"][s],
                                                  "v_acc": res["per_subject_valence"][s]}
                                         for s in range(N_SUBJECTS)},
                         "mean_arousal_acc": res["mean_arousal_acc"],
                         "mean_valence_acc": res["mean_valence_acc"]})
    assert sorted(os.listdir(tmp_path / "ckpt_vphased")) == sorted(
        os.path.basename(p) for p in vp.save_checkpoints(str(tmp_path / "lib")))
    assert len(os.listdir(tmp_path / "history")) == 1


@pytest.mark.parametrize("vectorized", [False, True])
def test_simclr_matches_library(tmp_path, vectorized):
    argv = ["simclr", "--pretrain-epochs", "1", "--finetune-epochs", "1"]
    got = run(tmp_path, "simclr", *argv, *(["--vectorized"] if vectorized else
                                           ["--subjects", "0"]))
    assert set(got) == JAX_KEYS["simclr"]
    assert all(set(v) == PER_SUBJECT_KEYS["simclr_vectorized" if vectorized else "simclr"]
               for v in got["per_subject"].values())
    modules = (MultiModalEncoder(FEAT, eeg_time=T_EEG, device=CPU, generator=generator(SEED)),
               ProjectionHead(FEAT, device=CPU, generator=generator(SEED + 1)),
               Classifier(FEAT, device=CPU, generator=generator(SEED + 2)))
    arrays = tiny_arrays()
    full = DeviceDataset(arrays, CPU)
    if vectorized:
        out = VectorizedSimCLRTrainer(*modules, full, N_SUBJECTS, EX_NUMS, seed=SEED,
                                      verbose=False).run(1, 1)
        per = out["per_subject"]
        want = {"per_subject": {str(s): {"a_acc": per["a_acc"][s], "v_acc": per["v_acc"][s]}
                                for s in range(N_SUBJECTS)},
                "mean_arousal_acc": out["mean_arousal_acc"],
                "mean_valence_acc": out["mean_valence_acc"]}
    else:
        tr, te = loso_split(N_SUBJECTS, EX_NUMS, 0)
        pidx, plab = build_contrastive_pairs(arrays["arousal"][tr], arrays["valence"][tr],
                                             subject_ids_array(N_SUBJECTS, EX_NUMS)[tr],
                                             seed=SEED)
        enc_vars, _, _ = contrastive_pretrain(modules[0], modules[1], full.subset(tr), pidx,
                                              plab, num_epochs=1, seed=SEED, verbose=False)
        _, final = finetune(modules[0], enc_vars, modules[2], full.subset(tr), full.subset(te),
                            num_epochs=1, seed=SEED, verbose=False)
        want = {"per_subject": {"0": final}, "mean_arousal_acc": final["a_acc"],
                "mean_valence_acc": final["v_acc"]}
    assert got == plain(want)


def test_memhacl_matches_library(tmp_path):
    got = run(tmp_path, "memhacl", "memhacl", "--n-samples", "16", "--pretrain-epochs", "1",
              "--finetune-epochs", "1")
    assert set(got) == JAX_KEYS["memhacl"]
    full = DeviceDataset(make_synthetic_emotion_arrays(n=16, seed=SEED), CPU)
    tr, va = random_split_indices(16, 0.8, seed=SEED)
    encoder = MEMHACLEncoder(device=CPU, generator=generator(SEED))
    enc_vars, _, _ = memhacl_pretrain(encoder, ProjectionHead(device=CPU,
                                                              generator=generator(SEED + 1)),
                                      full, num_epochs=1, seed=SEED, verbose=False)
    _, _, metrics = memhacl_finetune(encoder, enc_vars,
                                     MEMHACLClassifier(device=CPU, generator=generator(SEED + 2)),
                                     full.subset(tr), full.subset(va), num_epochs=1, seed=SEED,
                                     verbose=False)
    assert got == plain(metrics)
    assert 0.0 <= got["a_acc"] <= 1.0 and np.isfinite(got["loss_history"]).all()


# ---------------------------------------------------------------------------
# refusals, and the CLI without the optional packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["vloso", "--dp"], ["phased", "--dp", "--no-plots"],
                                  ["phased", "--vectorized", "--dp", "--no-plots"]])
def test_dp_raises(argv, tmp_path):
    """``--dp`` outside ``torchrun`` runs over a one-rank mesh: its results
    JSON equals the run's without ``--dp``."""
    runs = {}
    for dp in (True, False):
        out = tmp_path / f"dp{dp}.json"
        args = [a for a in argv if dp or a != "--dp"]
        epochs = ["1"] * (5 if argv[0] == "phased" else 1)
        try:
            cli.main([*args, "--tiny", "--device", "cpu", "--quiet", "--epochs", *epochs,
                      "--checkpoint-dir", str(tmp_path / f"ck{dp}"), "--results-json",
                      str(out)])
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        runs[dp] = json.loads(out.read_text())
    assert runs[True] == runs[False]


def test_cuda_without_a_card_raises():
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["inspect", "--tiny"])


def test_plots_without_matplotlib_raise_before_work(tmp_path):
    def no_pyplot():
        raise ImportError("No module named 'matplotlib'")

    with mock.patch("multimodal_sentiment_aanalysis_tpu_torch.eval.reporting._pyplot",
                    no_pyplot):
        with pytest.raises(RuntimeError, match="--no-plots"):
            cli.main(["phased", "--tiny", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert not os.path.exists(tmp_path / "ckpt")


def test_cli_runs_without_jax_yaml_sklearn_matplotlib():
    code = ("import sys\n"
            "for m in ('jax', 'multimodal_sentiment_aanalysis_tpu', 'yaml', 'sklearn', "
            "'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "from multimodal_sentiment_aanalysis_tpu_torch.cli import main\n"
            "main(['inspect', '--tiny', '--device', 'cpu'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "finite-check: OK" in out.stdout


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _requests(b: int, seed: int) -> tuple:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, 32, T_EEG, generator=g), torch.randn(b, 38, generator=g),
            torch.randn(b, 230, generator=g))


@pytest.mark.parametrize("flags", [(), ("--batch-size", "4"), ("--bf16",)])
def test_export(tmp_path, flags):
    from multimodal_sentiment_aanalysis_tpu_torch.eval import build_serving_forward, load_serving

    out = tmp_path / "serving.pt2"
    payload = run(tmp_path, "export", "export", "--output", str(out), *flags)
    assert payload == {"artifact_bytes": out.stat().st_size, "output": str(out)}
    x = _requests(4 if "--batch-size" in flags else 5, seed=1)
    got = load_serving(out)(*x)
    dtype = torch.bfloat16 if "--bf16" in flags else None
    want = build_serving_forward(flagship(SEED).eval(), FEAT, compute_dtype=dtype)(*x)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (len(x[0]), 3)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_export_of_a_saved_model(tmp_path):
    from multimodal_sentiment_aanalysis_tpu_torch.eval import build_serving_forward, load_serving

    model = flagship(7).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.2, generator=torch.Generator().manual_seed(8))
    path, out = tmp_path / "model.pt", tmp_path / "serving.pt2"
    torch.save(model.state_dict(), path)
    run(tmp_path, "export", "export", "--model-path", str(path), "--output", str(out))
    x = _requests(5, seed=2)
    for g, w in zip(load_serving(out)(*x), build_serving_forward(model, FEAT)(*x)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)
