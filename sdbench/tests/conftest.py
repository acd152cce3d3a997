"""The benchmark's CPU tests: ``python -m pytest sdbench/tests -q`` from the
repository's root. Tests that need a card carry the ``cuda`` marker and skip
without one (decided inside the test, never at import)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SDBENCH = os.path.dirname(HERE)
for path in (SDBENCH, os.path.dirname(SDBENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
