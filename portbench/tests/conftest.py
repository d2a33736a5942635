"""The harness's modules import each other by their top-level names, as
``run.py`` runs them; put the harness and the repo's root on the path."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE), HERE):
    if path not in sys.path:
        sys.path.insert(0, path)
