#!/usr/bin/env python3
"""Build sources of the rollout forward kernel and report, for each, what
ptxas says, its time on the card in turns at T=59 and M = 16 and 128, and
the time a step of each phase (P0|D0|P4, P1|D1 .. P3|D3, TL, from a clock
trace after every grid barrier) or, for a source that launches a kernel
a layer, of each of its kernels (torch.profiler).

    python3 scripts/rollout_fwd_study.py humor_torch/csrc/rollout_fwd.cu \
        _proof/old/rollout_fwd.cu

Each source has the C interface of humor_torch/csrc/rollout_fwd.cu. An
older source goes in a directory .gitignore lists, with the headers it was
written against beside it (`git show REV:humor_torch/csrc/<file>` for
each): they come before humor_torch/csrc on the include path. This is
scripts/rollout_bwd_study.py's study run for the forward; see it for the
details. Needs a GPU and nvcc; prints one JSON line per source, then the
card's name and power limit.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import rollout_bwd_study  # noqa: E402

if __name__ == "__main__":
    rollout_bwd_study.main("rollout_fwd")
