"""The benchmark of wc_path_tracer_tpu_torch on NVIDIA cards.

    python3 -m perfbench.run --workload cornell-train --seed 7 \\
        --seconds 25 --trace 0

runs one cell of BENCHMARK.json on the card(s) of this machine and prints
one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics),
``device`` and, last, ``checks`` (each number compared with its limit).
It exits with 2 and prints no result where the cell's cards are missing.
"""

from __future__ import annotations

import argparse
import sys


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from perfbench import harness

    started = harness.process_started()
    return harness.main(parse(argv), started)


if __name__ == "__main__":
    sys.exit(main())
