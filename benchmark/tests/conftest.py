"""The benchmark's own CPU tests: ``python -m pytest benchmark/tests`` from
the checkout's root. None needs a card: the program's plain versions stand
in for its CUDA kernels at a tiny size."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
