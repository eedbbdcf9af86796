"""The port's host data layer against the JAX package's on the CPU, bit for
bit (``np.array_equal`` and equal dtypes):

- the splits: ``kfold_split`` (sklearn ``KFold(shuffle=True)`` in JAX,
  numpy in the port) over several ``(n, k, seed)`` and a binary-filtered
  index set, ``subject_holdout_split`` (two sklearn ``train_test_split``
  calls in JAX), ``per_subject_count_split``, ``binary_label_filter``,
  ``loso_block_split``, and the refusals sklearn makes;
- ``per_subject_zscore``, ``au_group_normalize``, ``AuFeatures``,
  ``DataFeatures``, ``FeatureDataset`` and ``load_data`` (both
  ``dependent`` settings, ``num_classes`` 2 and 3);
- ``save_pickle`` -> ``RawData`` in both directions, a joblib-compressed
  dump, a missing path;
- ``Config().to_dict()``, ``flatten_config`` and ``load_config`` of a YAML
  file;
- ``native``: the C++ runtime against JAX ``native`` (the same source) bit
  for bit, and against its numpy plain versions (``build_pairs_plain`` bit
  for bit; the z-scores within 1e-6, float64 sums in another order).

Small synthetic sets (4 subjects x 10 trials) from seeds.
"""

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu import config as jconfig
from multimodal_sentiment_aanalysis_tpu import native as jnative
from multimodal_sentiment_aanalysis_tpu.data import dataset as jdataset
from multimodal_sentiment_aanalysis_tpu.data import features as jfeatures
from multimodal_sentiment_aanalysis_tpu.data import raw as jraw
from multimodal_sentiment_aanalysis_tpu.data import splits as jsplits
from multimodal_sentiment_aanalysis_tpu_torch import config, native
from multimodal_sentiment_aanalysis_tpu_torch.data import dataset, features, raw, splits
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N_SUBJECTS, EX_NUMS = 4, 10


def same(a, b) -> bool:
    """Equal arrays (or tuples of them) of equal dtypes."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.fixture(scope="module")
def hci():
    return raw.make_synthetic_hci_data(seed=3, n_subjects=N_SUBJECTS, ex_nums=EX_NUMS)


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,seed", [(480, 10, 42), (37, 5, 0), (24, 3, 7), (100, 7, 123),
                                      (10, 10, 1)])
def test_kfold_split_matches_sklearn(n, k, seed):
    for fold in range(k):
        assert same(splits.kfold_split(n, k, fold, random_state=seed),
                    jsplits.kfold_split(n, k, fold, random_state=seed)), fold


def test_kfold_split_of_binary_filtered_indices(hci):
    labels = np.asarray(hci["arousal_label"])
    idx, mapped = splits.binary_label_filter(labels)
    assert same((idx, mapped), jsplits.binary_label_filter(labels))
    for fold in range(10):
        assert same(splits.kfold_split(len(labels), 10, fold, indices=idx),
                    jsplits.kfold_split(len(labels), 10, fold, indices=idx)), fold


@pytest.mark.parametrize("n_subjects,ex_nums,test_size,val_size,seed",
                         [(24, 20, 0.15, 0.05, 42), (10, 3, 0.3, 0.1, 0), (20, 2, 0.15, 0.05, 5),
                          (50, 1, 0.2, 0.2, 9)])
def test_subject_holdout_split_matches_sklearn(n_subjects, ex_nums, test_size, val_size, seed):
    assert same(splits.subject_holdout_split(n_subjects, ex_nums, test_size, val_size, seed),
                jsplits.subject_holdout_split(n_subjects, ex_nums, test_size, val_size, seed))


@pytest.mark.parametrize("train,val,seed", [(16, 1, 42), (5, 2, 0)])
def test_per_subject_count_split_matches_jax(train, val, seed):
    assert same(splits.per_subject_count_split(24, 20, train, val, seed),
                jsplits.per_subject_count_split(24, 20, train, val, seed))


def test_loso_block_split_matches_jax(hci):
    idx, _ = splits.binary_label_filter(np.asarray(hci["arousal_label"]))
    n = N_SUBJECTS * EX_NUMS
    for person in (-1, 0, N_SUBJECTS - 1):
        for indices in (None, idx):
            assert same(splits.loso_block_split(n, EX_NUMS, person, indices),
                        jsplits.loso_block_split(n, EX_NUMS, person, indices))


def test_split_refusals():
    """Where sklearn (or the JAX assert) refuses, the port refuses too."""
    with pytest.raises(ValueError):
        jsplits.kfold_split(4, 5, 0)
    with pytest.raises(ValueError):
        splits.kfold_split(4, 5, 0)
    with pytest.raises(ValueError):
        splits.kfold_split(40, 5, 5)
    with pytest.raises(ValueError):  # 2 subjects left for the second split: no train
        jsplits.subject_holdout_split(7, 2)
    with pytest.raises(ValueError):
        splits.subject_holdout_split(7, 2)
    with pytest.raises(ValueError):
        splits.loso_block_split(40, 10, 4)


# ---------------------------------------------------------------------------
# features and datasets
# ---------------------------------------------------------------------------

def test_per_subject_zscore_and_au_group_normalize_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_SUBJECTS * EX_NUMS, 6, 5)).astype(np.float32)
    x[3, 1, 2] = np.nan
    assert same(features.per_subject_zscore(x, N_SUBJECTS, EX_NUMS),
                jfeatures.per_subject_zscore(x, N_SUBJECTS, EX_NUMS))
    au = rng.normal(size=(30, 17 * 7)).astype(np.float32) * 3 + 1
    assert same(features.au_group_normalize(au), jfeatures.au_group_normalize(au))
    assert same(features.au_group_normalize(au, 4, 5), jfeatures.au_group_normalize(au, 4, 5))


def test_au_features_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    (tmp_path / "au_feature").mkdir()
    subjects = [1, 2, 4]
    for s in subjects:
        a = rng.normal(size=(5, 119)).astype(np.float32)
        a[0, s] = np.nan
        np.save(tmp_path / "au_feature" / f"{s}.npy", a)
    path = str(tmp_path / "hci_data.pkl")
    got = features.AuFeatures(None, subjects, path).get_features()
    assert same(got, jfeatures.AuFeatures(None, subjects, path).get_features())
    with pytest.raises(FileNotFoundError):
        features.AuFeatures(None, [1, 9], path).compute_au_features()


def test_data_features_and_raw_data_round_trip(hci, tmp_path):
    port_path, jax_path = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    raw.save_pickle(hci, port_path)
    jraw.save_pickle(hci, jax_path)
    for path in (port_path, jax_path):
        a, b = raw.RawData(path).data, jraw.RawData(path).data
        assert a.keys() == b.keys() == hci.keys()
        for key in ("arousal_label", "valence_label", "subject_list"):
            assert same(a[key], b[key]) and same(a[key], hci[key])
        for m in ("eeg", "eye", "pps"):
            assert same(a["features"][m], hci["features"][m])
    for norm in (None, "Z_score", "Min_Max"):
        got = features.DataFeatures(port_path, Norm=norm, label_type="valence")
        want = jfeatures.DataFeatures(port_path, Norm=norm, label_type="valence")
        assert got.features.keys() == want.features.keys()
        assert all(same(got.features[m], want.features[m]) for m in got.features)
        assert same(got.label, want.label)
    with pytest.raises(FileNotFoundError):
        raw.RawData(str(tmp_path / "missing.pkl"))


def test_joblib_compressed_dump_loads(hci, tmp_path):
    joblib = pytest.importorskip("joblib")
    path = str(tmp_path / "hci.joblib")
    joblib.dump({"arousal_label": hci["arousal_label"]}, path, compress=3)
    assert same(raw.RawData(path).data["arousal_label"], hci["arousal_label"])


@pytest.mark.parametrize("cls_num", [2, 3])
@pytest.mark.parametrize("dependent", [False, True])
def test_feature_dataset_matches_jax(hci, cls_num, dependent):
    feats, labels = features.assemble_features(hci, ["eeg", "eye", "pps"])
    for mode in ("train", "test"):
        kw = dict(ex_nums=EX_NUMS, mode=mode, test_person=1, cls_num=cls_num,
                  dependent=dependent, n_splits=5)
        got = dataset.FeatureDataset(feats, labels, **kw)
        want = jdataset.FeatureDataset(feats, labels, **kw)
        assert same(got.indices, want.indices) and same(got.labels, want.labels)
        assert len(got) == len(want) > 0
        assert all(same(got.features[m], want.features[m]) for m in feats)
        x, y = got[2]
        xj, yj = want[2]
        assert all(same(x[m], xj[m]) for m in feats) and y == yj


@pytest.mark.parametrize("num_classes", [2, 3])
@pytest.mark.parametrize("dependent", [False, True])
def test_load_data_matches_jax(hci, num_classes, dependent):
    def cfg(module):
        c = module.Config()
        c.num_classes = num_classes
        c.training.dependent = dependent
        c.training.n_folds = 5
        c.data.HCI.ex_nums = EX_NUMS
        c.data.HCI.label_type = "valence"
        return c

    got = dataset.load_data(cfg(config), test_person=2, data=hci, device="cpu")
    want = jdataset.load_data(cfg(jconfig), test_person=2, data=hci)
    for g, w in zip(got, want):
        assert g.device == torch.device("cpu") and len(g) == len(w) > 0
        assert g.arrays.keys() == w.arrays.keys()
        for k in g.arrays:
            want_k = np.asarray(w.arrays[k])
            if want_k.dtype == np.int32:  # JAX without x64 holds the int64 labels as int32
                want_k = want_k.astype(np.int64)
            assert same(g.arrays[k].numpy(), want_k), k


def test_load_data_reads_the_pickle(hci, tmp_path):
    path = str(tmp_path / "hci.pkl")
    raw.save_pickle(hci, path)
    c = config.Config()
    c.data.HCI.data_path = path
    c.data.HCI.ex_nums = EX_NUMS
    c.training.dependent = False
    from_file = dataset.load_data(c, test_person=0, device="cpu")
    given = dataset.load_data(c, test_person=0, data=hci, device="cpu")
    for a, b in zip(from_file, given):
        assert all(torch.equal(a.arrays[k], b.arrays[k]) for k in a.arrays)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_matches_jax():
    assert config.Config().to_dict() == jconfig.Config().to_dict()
    assert config.flatten_config(config.Config()) == jconfig.flatten_config(jconfig.Config())
    c = config.Config()
    assert c["data"]["HCI"]["ex_nums"] == 20 and c["training"]["batch_size"] == 64


def test_load_config_of_a_yaml_file_matches_jax(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(
        "training:\n  batch_size: 32\n  epochs: 7\n  dependent: false\n  unknown_key: 1\n"
        "data:\n  name: HCI\n  HCI:\n    ex_nums: 10\n    label_type: valence\n"
        "    subject_lists: [1, 2, 4]\n"
        "logging:\n  log_dir: runs\n"
        "device:\n  gpu_ids: [0, 1]\n"
        "seed: 7\nnum_classes: 2\n")
    got, want = config.load_config(str(path)), jconfig.load_config(str(path))
    assert got.to_dict() == want.to_dict()
    assert got.training.batch_size == 32 and got.data.HCI.label_type == "valence"
    assert config.flatten_config(got) == jconfig.flatten_config(want)
    assert config.load_config(None).to_dict() == config.Config().to_dict()


# ---------------------------------------------------------------------------
# native
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native runtime did not build")
    return jnative


def test_native_normalisations_match_jax_and_plain(jax_native):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    x[0, 0], x[1, 1], x[2, 2] = np.nan, np.inf, -np.inf
    got = native.nan_to_num_(x.copy())
    assert same(got, jax_native.nan_to_num_(x.copy()))
    assert same(got, native.nan_to_num_plain(x))

    x = rng.normal(size=(480, 230)).astype(np.float32) * 5 + 3
    x[:, 7] = 2.5  # a zero-std column takes the guard
    got = native.zscore_columns_(x.copy())
    assert same(got, jax_native.zscore_columns_(x.copy()))
    np.testing.assert_allclose(got, native.zscore_columns_plain(x), rtol=0, atol=1e-6)

    x = rng.normal(size=(24, 20, 38)).astype(np.float32)
    got = native.global_norm_(x.copy())
    assert same(got, jax_native.global_norm_(x.copy()))
    np.testing.assert_allclose(got, native.global_norm_plain(x), rtol=0, atol=1e-6)

    with pytest.raises(ValueError):
        native.zscore_columns_(x.copy())  # 3 dims
    with pytest.raises(ValueError):
        native.nan_to_num_(x.astype(np.float64))


@pytest.mark.parametrize("n_subjects,per,classes,seed", [(6, 20, 3, 0), (3, 15, 2, 7),
                                                        (2, 1, 2, 1)])
def test_native_build_pairs_matches_jax_and_plain(jax_native, n_subjects, per, classes, seed):
    rng = np.random.default_rng(seed)
    subject_ids = np.repeat(np.arange(n_subjects), per)
    arousal = rng.integers(0, classes, n_subjects * per)
    valence = rng.integers(0, classes, n_subjects * per)
    got = native.build_pairs(arousal, valence, subject_ids, seed=seed)
    assert same(got, jax_native.build_pairs(arousal, valence, subject_ids, seed=seed))
    assert same(got, native.build_pairs_plain(arousal, valence, subject_ids, seed=seed))
    pairs, labels = got
    assert labels.sum() * 2 == len(labels)
    for (i, j), lab in zip(pairs, labels):
        assert subject_ids[i] == subject_ids[j] and i != j
        assert lab == float(arousal[i] == arousal[j] and valence[i] == valence[j])


def test_native_builds_under_build_dir():
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert lib.parent.parent.name == "build"
