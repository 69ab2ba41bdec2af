"""The benchmark's tests: CPU tests at tiny sizes, and card-only cases
(marker `gpu`) that decide inside the test whether a card is there."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
