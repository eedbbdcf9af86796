"""The port's modules (``multimodal_sentiment_aanalysis_tpu_torch.models``)
against the JAX package's flax modules, eval mode.

The JAX model is initialised at the CLI's ``--tiny`` dims (feat_dim=32,
eeg_time=64) with non-trivial BatchNorm running stats; its variables go
through :func:`state_dict_from_jax_variables` into the port, and each
module's output on the same numpy inputs must match, rtol/atol 1e-5 (fp32
summation order); the whole model's logits atol 1e-4.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_sentiment_aanalysis_tpu import models as jmodels
from multimodal_sentiment_aanalysis_tpu.models.torch_import import (
    variables_from_torch_state_dict,
)
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MultimodalTransformerModel,
    state_dict_from_jax_variables,
)
from multimodal_sentiment_aanalysis_tpu_torch.models.layers import make_sincos_pe
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F_TINY, T_TINY, B = 32, 64, 5


def jax_variables(feat_dim, eeg_time, seed=0):
    """JAX model variables with running stats drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    model = jmodels.MultimodalTransformerModel(feat_dim=feat_dim, eeg_time=eeg_time)
    v = model.init(jax.random.key(seed), jnp.zeros((2, 32, eeg_time)),
                   jnp.zeros((2, 38)), jnp.zeros((2, 230)))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 1.5, x.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.2, x.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}


def inputs(b, eeg_time, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, eeg_time)).astype(np.float32),
            rng.normal(size=(b, 38)).astype(np.float32),
            rng.normal(size=(b, 230)).astype(np.float32))


@pytest.fixture(scope="module")
def tiny():
    v = jax_variables(F_TINY, T_TINY)
    port = MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY).eval()
    port.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    return v, port


def _close(got: torch.Tensor, ref, atol=1e-5):
    assert tuple(got.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=atol)


def test_sincos_pe_matches_jax():
    from multimodal_sentiment_aanalysis_tpu.models.layers import make_sincos_pe as jax_pe

    _close(make_sincos_pe(32, 100), jax_pe(32, 100), atol=1e-6)


def test_multihead_attention_matches_jax(tiny):
    """Length 5, so the softmax is not the identity it is on the model path."""
    v, port = tiny
    p = v["params"]["eye_net"]["transformer"]["layers_0"]["self_attn"]
    rng = np.random.default_rng(2)
    q, k, val = (rng.normal(size=(B, n, F_TINY)).astype(np.float32) for n in (3, 5, 5))
    ref = jmodels.MultiheadAttention(F_TINY, 4).apply({"params": p}, q, k, val)
    with torch.no_grad():
        got = port.eye_net.transformer.layers[0].self_attn(
            *map(torch.from_numpy, (q, k, val)))
    _close(got, ref)


def test_transformer_layer_matches_jax(tiny):
    v, port = tiny
    p = v["params"]["pps_net"]["transformer"]["layers_1"]
    h = np.random.default_rng(3).normal(size=(B, 1, F_TINY)).astype(np.float32)
    ref = jmodels.TransformerEncoderLayer(F_TINY, 4, 3 * F_TINY).apply({"params": p}, h)
    with torch.no_grad():
        got = port.pps_net.transformer.layers[1](torch.from_numpy(h))
    _close(got, ref)


@pytest.mark.parametrize("name,dim", [("eye_net", 38), ("pps_net", 230)])
def test_subnetwork_matches_jax(tiny, name, dim):
    v, port = tiny
    x = np.random.default_rng(4).normal(size=(B, dim)).astype(np.float32)
    ref = jmodels.Subnetwork(dim, F_TINY).apply({"params": v["params"][name]}, x)
    with torch.no_grad():
        got = getattr(port, name)(torch.from_numpy(x))
    _close(got, ref)


@pytest.mark.parametrize("name", ["cross_attn_e2p", "cross_attn_p2e"])
def test_cross_modal_matches_jax(tiny, name):
    v, port = tiny
    rng = np.random.default_rng(5)
    q, kv = (rng.normal(size=(B, F_TINY)).astype(np.float32) for _ in range(2))
    ref = jmodels.CrossModalTransformer(F_TINY).apply({"params": v["params"][name]}, q, kv, kv)
    with torch.no_grad():
        got = getattr(port, name)(torch.from_numpy(q), torch.from_numpy(kv),
                                  torch.from_numpy(kv))
    _close(got, ref)


def test_eeg_encoder_matches_jax(tiny):
    v, port = tiny
    eeg = inputs(B, T_TINY)[0]
    ref = jmodels.EEGMultiScaleNet(32, T_TINY, F_TINY).apply(
        {"params": v["params"]["eeg_net"], "batch_stats": v["batch_stats"]["eeg_net"]}, eeg)
    with torch.no_grad():
        got = port.eeg_net(torch.from_numpy(eeg))
    _close(got, ref)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(x)
            for k, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_import_round_trip_is_exact(tiny):
    """``variables_from_torch_state_dict`` inverts ``state_dict_from_jax_variables``,
    leaf for leaf, bit for bit."""
    v, port = tiny
    for sd in (state_dict_from_jax_variables(v), port.state_dict()):
        back = _leaves(variables_from_torch_state_dict(sd))
        want = _leaves(v)
        assert back.keys() == want.keys()
        for k in want:
            assert back[k].dtype == want[k].dtype and back[k].shape == want[k].shape, k
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_port_init_imports_into_jax():
    """A port model made from a generator carries the JAX model's variable
    tree and its logits through ``torch_import``."""
    port = MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY,
                                      generator=torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.2, generator=torch.Generator().manual_seed(4))
    variables = variables_from_torch_state_dict(port.state_dict())
    model = jmodels.MultimodalTransformerModel(feat_dim=F_TINY, eeg_time=T_TINY)
    eeg, eye, pps = inputs(B, T_TINY)
    ref_tree = model.init(jax.random.key(0), eeg, eye, pps)
    assert _leaves(variables).keys() == _leaves(ref_tree).keys()
    ja, jv = model.apply(variables, eeg, eye, pps)
    a, v = port(*map(torch.from_numpy, (eeg, eye, pps)))
    _close(a, ja, atol=1e-4)
    _close(v, jv, atol=1e-4)


def test_generator_init_is_deterministic():
    make = lambda seed: MultimodalTransformerModel(
        feat_dim=F_TINY, eeg_time=T_TINY, generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["eeg_net.temp_conv.0.weight"], c["eeg_net.temp_conv.0.weight"])


def test_train_mode_and_labels_raise(tiny):
    """Train mode and the labels branch run (the serving slice refused
    both); what raises now is a labels tuple that does not fit the batch."""
    port = copy.deepcopy(tiny[1])  # train mode moves the running stats
    eeg, eye, pps = map(torch.from_numpy, inputs(2, T_TINY))
    with pytest.raises(ValueError):
        port(eeg, eye, pps, labels=(torch.zeros(3, dtype=torch.long),) * 2)
    labels = (torch.tensor([0, 1]), torch.tensor([2, 0]))
    for mode in (port.eval, port.train):
        mode()
        out = port(eeg, eye, pps, labels=labels, generator=torch.Generator().manual_seed(0))
        assert len(out) == 5 and all(torch.isfinite(o).all() for o in out)
        assert out[0].shape == out[1].shape == (2, 3) and out[2].shape == ()
