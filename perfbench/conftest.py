"""pytest set-up for the benchmark's own tests (``perfbench/tests``): the
checkout's root and the program's ``src`` on the import path.  The tests
run on the CPU at sizes a test run holds; none needs a card."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
