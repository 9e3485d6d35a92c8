#!/usr/bin/env python
"""Headline benchmark: the CT-mode fluid FDTD cell of ``bench_suite.py``.

CT mode (quantized-HU fluid media; the reference disables shear for CT
mapping) at 500 kHz and 6 PPW on a 192x192x240 grid, through ``run_fdtd``'s
compiled XLA scan, timed to ``block_until_ready``. Needs a GPU; prints the
card's name and power limit, then one JSON line.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench_suite  # noqa: E402

if __name__ == "__main__":
    bench_suite.main(["fdtd_fluid_ct"])
