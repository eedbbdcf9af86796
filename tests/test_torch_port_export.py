"""The op library and the serving artifacts of the port, on the CPU.

- ``torch.library.opcheck`` on each custom op of ``kernels.library``
  (``msa_torch::bilstm_fwd``, ``bilstm_rec``, ``bilstm_fwd_xp``,
  ``conv_stem``) at small shapes, in fp32 and, where the op has a bf16 form,
  in bf16: its schema, its fake implementation against the CPU one, and a
  trace with dynamic shapes;
- ``export_serving`` / ``load_serving``: a fixed-batch artifact (``use_pallas``
  on and off) saved, loaded and run, its logits within 1e-5 of the port's
  ``build_serving_forward`` on the same weights (the same ops in the same
  order: measured bit-equal) and within 1e-4 of the JAX package's own
  artifact, ``load_serving(export_serving(variables, batch_size=8,
  use_pallas=False))`` (the serving slice's bar, ``test_torch_port_serving.py``),
  at the CLI's ``--tiny`` dims and at full width, weights crossing through
  ``state_dict_from_jax_variables``;
- a fixed batch-64 artifact no more than 1 MB larger than the polymorphic
  one (no example inputs stored), and loaded and run;
- one batch-polymorphic artifact at batches 1, 3 and 8; the bf16 artifact's
  fp32 logits against the bf16 closure (1e-5) and against fp32 serving at
  the JAX package's bar for bf16 serving (0.1, ``tests/test_serving.py``);
- which ops each artifact's graph holds: ``conv_stem`` only for a fixed
  batch with ``use_pallas=True``, ``bilstm_fwd_xp`` in place of
  ``bilstm_fwd`` under v5;
- a fresh process loads and runs an artifact importing neither the port's
  ``models`` nor ``eval.serving`` nor JAX;
- ``utils.dump_graph`` names the ops, with the batch symbolic.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_sentiment_aanalysis_tpu.eval.export import (
    export_serving as jax_export_serving,
    load_serving as jax_load_serving,
)
from multimodal_sentiment_aanalysis_tpu_torch.eval import (
    build_serving_forward,
    export_serving,
    load_serving,
)
from multimodal_sentiment_aanalysis_tpu_torch.kernels import library
from multimodal_sentiment_aanalysis_tpu_torch.models import (
    MultimodalTransformerModel,
    state_dict_from_jax_variables,
)
from multimodal_sentiment_aanalysis_tpu_torch.utils import dump_graph

from test_torch_port_models import inputs, jax_variables
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BF16 = torch.bfloat16
DIMS = {"tiny": (32, 64), "full": (256, 585)}  # feat_dim, eeg_time
CLOSURE_ATOL = 1e-5  # an artifact against its own closure: the same ops in the same order
JAX_ATOL = 1e-4      # against the JAX artifact: fp32 sums in other orders, BN folded
BF16_BAR = 0.1       # bf16 against fp32 serving, the JAX package's bar


def _schema(eeg_time: int) -> tuple:
    return (((32, eeg_time), torch.float32), ((38,), torch.float32), ((230,), torch.float32))


def _graph_ops(blob: bytes) -> set[str]:
    program = torch.export.load(io.BytesIO(blob))
    return {str(n.target).split(".")[1] for n in program.graph.nodes
            if str(n.target).startswith("msa_torch.")}


def _close(got, want, atol: float) -> None:
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.fixture(scope="module", params=sorted(DIMS))
def case(request):
    """JAX variables, the port's model on the same weights, and 8 requests."""
    feat_dim, eeg_time = DIMS[request.param]
    v = jax_variables(feat_dim, eeg_time, seed=21)
    port = MultimodalTransformerModel(feat_dim=feat_dim, eeg_time=eeg_time).eval()
    port.load_state_dict(state_dict_from_jax_variables(v), strict=True)
    return feat_dim, eeg_time, v, port, inputs(8, eeg_time, seed=22)


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------


def _lstm_args(seed: int, dtype, models: int | None = None):
    s = () if models is None else (models,)
    g = torch.Generator().manual_seed(seed)
    mk = lambda *shape: (0.3 * torch.randn(*s, *shape, generator=g)).to(dtype)
    b, t, i, h = 3, 5, 8, 4
    return b, t, i, h, mk


OP_CASES = {
    "bilstm_fwd fp32": ("bilstm_fwd", torch.float32, None),
    "bilstm_fwd bf16": ("bilstm_fwd", BF16, None),
    "bilstm_fwd fp32 S=2": ("bilstm_fwd", torch.float32, 2),
    "bilstm_rec fp32": ("bilstm_rec", torch.float32, None),
    "bilstm_rec bf16": ("bilstm_rec", BF16, None),
    "bilstm_rec bf16 S=2": ("bilstm_rec", BF16, 2),
    "bilstm_fwd_xp fp32": ("bilstm_fwd_xp", torch.float32, None),
    "bilstm_fwd_xp fp32 S=2": ("bilstm_fwd_xp", torch.float32, 2),
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_opcheck_lstm_ops(name):
    op, dtype, models = OP_CASES[name]
    b, t, i, h, mk = _lstm_args(1, dtype, models)
    w_hh = mk(2, 4 * h, h)
    if op == "bilstm_fwd":
        args = (mk(b, t, i), mk(2, 4 * h, i), w_hh, mk(2, 4 * h))
    else:  # the packed projection is fp32 in every form
        args = (mk(b, t, 8 * h).float(), w_hh)
    torch.library.opcheck(library.OPS[op], args)


@pytest.mark.parametrize("pool, padding", [(4, 7), (2, 2), (1, 0)])
def test_opcheck_conv_stem(pool, padding):
    g = torch.Generator().manual_seed(pool)
    args = (torch.randn(3, 20, 6, generator=g), torch.randn(10, 6, 2 * padding + 1, generator=g),
            torch.rand(10, generator=g) + 0.5, torch.randn(10, generator=g), padding, pool)
    torch.library.opcheck(library.OPS["conv_stem"], args)


def test_wrappers_go_through_the_ops():
    """The wrappers' results are the ops' on the CPU (the plain versions),
    and a symbolic batch traces through them to one op node each."""
    b, t, i, h, mk = _lstm_args(2, torch.float32)
    x, w_ih, w_hh, bias = mk(b, t, i), mk(2, 4 * h, i), mk(2, 4 * h, h), mk(2, 4 * h)
    from multimodal_sentiment_aanalysis_tpu_torch.kernels import lstm

    assert torch.equal(lstm.bilstm_fwd(x, w_ih, w_hh, bias),
                       lstm.bilstm_fwd_plain(x, w_ih, w_hh, bias))
    text = dump_graph(lambda x: lstm.fused_bilstm_layer(
        x, (w_ih[0], w_hh[0], bias[0], 0 * bias[0]), (w_ih[1], w_hh[1], bias[1], 0 * bias[1])),
        x, dynamic_batch=True)
    assert text.count("torch.ops.msa_torch.bilstm_fwd.default(") == 1


# --------------------------------------------------------------------------
# the artifacts
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_artifact_logits(case):
    feat_dim, eeg_time, v, _, x = case
    import jax.numpy as jnp

    schema = tuple((shape, jnp.float32) for shape, _ in _schema(eeg_time))
    blob = jax_export_serving(v, batch_size=8, feat_dim=feat_dim, use_pallas=False,
                              input_schema=schema)
    return tuple(np.asarray(o) for o in jax_load_serving(blob)(*x))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fixed_batch_round_trip(case, jax_artifact_logits, use_pallas, tmp_path):
    feat_dim, eeg_time, _, port, x = case
    path = tmp_path / "serving.pt2"
    blob = export_serving(port, path, batch_size=8, feat_dim=feat_dim, use_pallas=use_pallas,
                          input_schema=_schema(eeg_time))
    assert path.read_bytes() == blob
    xt = tuple(map(torch.from_numpy, x))
    got = load_serving(path)(*xt)
    assert all(g.dtype == torch.float32 and g.shape == (8, 3) for g in got)
    _close(got, build_serving_forward(port, feat_dim, use_pallas=use_pallas)(*xt), CLOSURE_ATOL)
    _close(got, jax_artifact_logits, JAX_ATOL)
    assert ("conv_stem" in _graph_ops(blob)) == use_pallas


def test_polymorphic_artifact_serves_any_batch(case):
    feat_dim, eeg_time, _, port, _ = case
    blob = export_serving(port, feat_dim=feat_dim, use_pallas=True,
                          input_schema=_schema(eeg_time))
    assert _graph_ops(blob) == {"bilstm_fwd"}  # a symbolic batch takes the F.conv1d stem
    fwd, closure = load_serving(blob), build_serving_forward(port, feat_dim)
    for b in (1, 3, 8):
        x = tuple(map(torch.from_numpy, inputs(b, eeg_time, seed=30 + b)))
        got = fwd(*x)
        assert all(g.shape == (b, 3) for g in got)
        _close(got, closure(*x), CLOSURE_ATOL)


def test_artifact_stores_no_example_inputs(case):
    """A fixed batch-64 artifact is no larger than the polymorphic one but
    for its graph: the traced example inputs (4.9 MB of zeros at batch 64,
    full width) are not stored, and loading needs none."""
    feat_dim, eeg_time, _, port, _ = case
    fixed = export_serving(port, batch_size=64, feat_dim=feat_dim, input_schema=_schema(eeg_time))
    poly = export_serving(port, feat_dim=feat_dim, input_schema=_schema(eeg_time))
    assert len(fixed) <= len(poly) + 1_000_000, (len(fixed), len(poly))
    assert torch.export.load(io.BytesIO(fixed)).example_inputs is None
    x = tuple(torch.zeros(64, *shape) for shape, _ in _schema(eeg_time))
    _close(load_serving(fixed)(*x), build_serving_forward(port, feat_dim)(*x), CLOSURE_ATOL)


def test_bf16_artifact(case):
    feat_dim, eeg_time, _, port, x = case
    xt = tuple(map(torch.from_numpy, x))
    got = load_serving(export_serving(port, feat_dim=feat_dim, compute_dtype=BF16,
                                      input_schema=_schema(eeg_time)))(*xt)
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, build_serving_forward(port, feat_dim, compute_dtype=BF16)(*xt), CLOSURE_ATOL)
    fp32 = build_serving_forward(port, feat_dim)(*xt)
    for g, r in zip(got, fp32):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=BF16_BAR, atol=BF16_BAR)


def test_v5_artifact_holds_the_v5_op():
    port = MultimodalTransformerModel(feat_dim=32, eeg_time=64,
                                      generator=torch.Generator().manual_seed(3)).eval()
    blob = export_serving(port, batch_size=4, feat_dim=32, lstm_schedule="v5",
                          input_schema=_schema(64))
    assert _graph_ops(blob) == {"bilstm_fwd_xp"}
    x = tuple(map(torch.from_numpy, inputs(4, 64, seed=5)))
    _close(load_serving(blob)(*x), build_serving_forward(port, 32, lstm_schedule="v5")(*x),
           CLOSURE_ATOL)


def test_artifact_loads_without_model_code(tmp_path):
    """A fresh process with the op library imported loads and runs an
    artifact; the port's ``models`` and ``eval.serving`` and JAX stay out of
    ``sys.modules``."""
    port = MultimodalTransformerModel(feat_dim=32, eeg_time=64,
                                      generator=torch.Generator().manual_seed(4)).eval()
    path = tmp_path / "serving.pt2"
    export_serving(port, path, feat_dim=32, input_schema=_schema(64))
    x = tuple(map(torch.from_numpy, inputs(5, 64, seed=6)))
    want = build_serving_forward(port, 32)(*x)
    np.save(tmp_path / "want.npy", torch.stack(want).numpy())
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "from multimodal_sentiment_aanalysis_tpu_torch.eval.export import load_serving\n"
        "x = np.random.default_rng(6)\n"
        "eeg = x.normal(size=(5, 32, 64)).astype(np.float32)\n"
        "eye = x.normal(size=(5, 38)).astype(np.float32)\n"
        "pps = x.normal(size=(5, 230)).astype(np.float32)\n"
        f"got = load_serving({str(path)!r})(*map(torch.from_numpy, (eeg, eye, pps)))\n"
        f"want = np.load({str(tmp_path / 'want.npy')!r})\n"
        "assert np.abs(torch.stack(got).numpy() - want).max() <= 1e-5\n"
        "p = 'multimodal_sentiment_aanalysis_tpu_torch.'\n"
        "bad = sorted(n for n in sys.modules if n.startswith((p + 'models', p + 'eval.serving',\n"
        "             p + 'train', 'jax', 'flax', 'multimodal_sentiment_aanalysis_tpu.')))\n"
        "assert not bad, bad\n"
        "print('loaded')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and "loaded" in out.stdout, out.stderr


def test_dump_graph_names_the_ops():
    port = MultimodalTransformerModel(feat_dim=32, eeg_time=64).eval()
    x = tuple(map(torch.from_numpy, inputs(4, 64, seed=7)))
    from multimodal_sentiment_aanalysis_tpu_torch.eval.serving import ServingModule

    text = dump_graph(ServingModule(port, 32, use_pallas=True), *x)
    assert text.count("torch.ops.msa_torch.conv_stem.default(") == 2
    assert text.count("torch.ops.msa_torch.bilstm_fwd.default(") == 2
    text = dump_graph(ServingModule(port, 32), *x, dynamic_batch=True)
    assert "msa_torch.conv_stem" not in text and "Range constraints" in text
