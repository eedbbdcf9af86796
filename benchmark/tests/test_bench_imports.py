"""Nothing the benchmark's run loads imports JAX, jaxlib, flax or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and nothing in ``benchmark/reference`` imports the port."""

import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]

LOADS = """
import sys, runpy
sys.path.insert(0, {root!r})
runpy.run_path({root!r} + "/benchmark/run.py", run_name="not_main")
from benchmark import harness, training, roofline
for name in ("loso", "simclr_pretrain"):
    harness.load_entry(name)
for m in harness.manifest()["per_layer"]:
    harness.load_metric(m["name"])
import multimodal_sentiment_aanalysis_tpu_torch.train.vloso
import multimodal_sentiment_aanalysis_tpu_torch.train.vsimclr
import multimodal_sentiment_aanalysis_tpu_torch.models.fusion_model
import multimodal_sentiment_aanalysis_tpu_torch.models.simclr
import multimodal_sentiment_aanalysis_tpu_torch.kernels._build
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.flagship, benchmark.reference.simclr, benchmark.reference.train
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], check=True,
                         capture_output=True, text=True, cwd=ROOT, env={"PATH": "/usr/bin:/bin"})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    loaded = _top_level(LOADS)
    assert "multimodal_sentiment_aanalysis_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_reference_imports_no_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & (set(harness.FORBIDDEN) | {"multimodal_sentiment_aanalysis_tpu_torch"})


def test_forbidden_compares_whole_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".", 1)[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "multimodal_sentiment_aanalysis_tpu_torch.probe", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert harness.forbidden_modules() == ["flax"]
