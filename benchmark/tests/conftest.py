"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository. The ``gpu`` tests run on a card with ``python -m
pytest -m gpu benchmark/tests``."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
