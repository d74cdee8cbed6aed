"""The benchmark's own tests, on the CPU: ``python -m pytest bench_port/tests``.

They import the harness from ``bench_port/`` and the port from the
checkout's root, and all run on the CPU: the card's readings come from
``control.py`` and the benchmark's own runs.  Under ``-n`` give each
worker few threads (``OMP_NUM_THREADS=2``): torch's default of one a
core, in every worker, oversubscribes the cores and the whole runs take
ten times as long.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)
