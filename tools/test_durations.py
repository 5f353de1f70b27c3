#!/usr/bin/env python3
"""Sum the ``--durations=0`` report of pytest runs, per test file.

    python -m pytest tests/test_torch_*.py -q -n 6 --dist load \\
        --durations=0 -p no:randomly > run.log
    python3 tools/test_durations.py run.log [other.log ...] [--top N]

Prints, for each log, the summed setup + call + teardown seconds of every
test file and their total, side by side, then the N longest entries of
the last log.  Run each log's pytest under a fresh ``HOME`` to start from
a cold JAX compilation cache, as a new checkout does.
"""
import argparse
import collections
import re

LINE = re.compile(r"^([\d.]+)s (setup|call|teardown)\s+(\S+)")


def load(path):
    """({file: seconds}, [(seconds, phase, test id)]) of one log."""
    files, rows = collections.Counter(), []
    with open(path) as f:
        for line in f:
            m = LINE.match(line)
            if m:
                t = float(m.group(1))
                files[m.group(3).split("::")[0]] += t
                rows.append((t, m.group(2), m.group(3)))
    return files, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("logs", nargs="+")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    runs = [load(p) for p in args.logs]
    names = sorted(set().union(*(f for f, _ in runs)),
                   key=lambda n: -runs[0][0].get(n, 0.0))
    for n in names:
        print(f"{n:60s}" + "".join(f"{f.get(n, 0.0):10.1f}"
                                   for f, _ in runs))
    print(f"{'total':60s}" + "".join(f"{sum(f.values()):10.2f}"
                                     for f, _ in runs))
    for t, phase, test in sorted(runs[-1][1], reverse=True)[:args.top]:
        print(f"{t:8.2f} {phase:8s} {test}")


if __name__ == "__main__":
    main()
