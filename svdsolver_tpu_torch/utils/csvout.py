"""Benchmark CSV emission in the reference's schema (twin of
``svdsolver_tpu/utils/csvout.py``).

Reference files (``data/<model>_benchmark.csv``): one line of
comma-separated matrix sizes, one line of stage-1 mean seconds, and, for a
two-stage model, one line of stage-2 mean seconds.  Values are seconds.
"""

import os


def write_benchmark_csv(path, sizes, times_1, times_2=None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = [
        ", ".join(str(int(s)) for s in sizes),
        ", ".join(f"{t:g}" for t in times_1),
    ]
    if times_2 is not None:
        lines.append(", ".join(f"{t:g}" for t in times_2))
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path
