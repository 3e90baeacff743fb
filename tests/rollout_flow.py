"""A CPU replay of the rollout kernels' dataflow
(humor_torch/csrc/rollout_persistent.cuh): tasks that wait on monotone
integer counters and add to others when they end, run one at a time on
buffers kept as the kernels keep them.

A task's reads and writes happen when it runs. `run` takes a strategy:
"walk" runs the tasks in the order every block of the kernel follows
(sorted by each task's `order` key) and fails if a task's waits are not
met when its turn comes, which is the kernels' claim that every wait
points to an earlier task; any other name picks, among the tasks whose
waits are met, the one its key ranks first (ties broken by a seeded
draw), so the replay follows an order that the declared waits allow but
no barrier or block order would impose:

    random       any ready task, uniformly
    prior_lags   the prior's tasks only when nothing else is ready
    run_ahead    the latest iteration first
    finish_first finishes before products, lower layers first
    product_first products before finishes, lower layers first

A wait nobody can meet raises (a deadlock of the declared waits).
"""

from __future__ import annotations

import heapq
import random
from typing import Callable, Dict, List, Sequence, Tuple

STRATEGIES = ("random", "prior_lags", "run_ahead", "finish_first",
              "product_first")
KIND_RANK = {"product": 0, "finish": 1, "tail": 2}


class Flow:
    """Tasks with waits [(counter, need)], a `run` callable and the
    counters they add one to, with attributes: kind (product, finish,
    tail), chain (prior, decoder, tail), layer, order (the kernel's walk
    order, a tuple)."""

    def __init__(self):
        self.tasks: List[Tuple[Dict, List, Callable, Sequence]] = []

    def add(self, attrs: Dict, waits, run: Callable, signals) -> None:
        self.tasks.append((attrs, [(c, n) for c, n in waits if n > 0], run,
                           tuple(signals)))

    def _key(self, strategy: str, attrs: Dict, draw: float):
        kind = KIND_RANK[attrs["kind"]]
        if strategy == "random":
            return (draw,)
        if strategy == "prior_lags":
            return (attrs["chain"] == "prior", draw)
        if strategy == "run_ahead":
            return (-attrs["order"][0], draw)
        if strategy == "finish_first":
            return (-kind, attrs["layer"], draw)
        if strategy == "product_first":
            return (kind, attrs["layer"], draw)
        raise ValueError(strategy)

    def run(self, strategy: str = "walk", seed: int = 0) -> None:
        count: Dict = {}
        if strategy == "walk":
            for attrs, waits, run, signals in sorted(
                    self.tasks, key=lambda task: task[0]["order"]):
                short = [(c, n) for c, n in waits if count.get(c, 0) < n]
                assert not short, (
                    f"{attrs} waits on a later task: {short[:4]}")
                run()
                for c in signals:
                    count[c] = count.get(c, 0) + 1
            return
        rng = random.Random(seed)
        blocked: Dict = {}
        missing = [0] * len(self.tasks)
        ready: List = []
        tick = 0

        def push(i):
            nonlocal tick
            heapq.heappush(ready, (self._key(strategy, self.tasks[i][0],
                                             rng.random()), tick, i))
            tick += 1

        for i, (_, waits, _, _) in enumerate(self.tasks):
            for c, need in waits:
                missing[i] += 1
                heapq.heappush(blocked.setdefault(c, []), (need, i))
            if not missing[i]:
                push(i)
        done = 0
        while ready:
            _, _, i = heapq.heappop(ready)
            _, _, run, signals = self.tasks[i]
            run()
            done += 1
            for c in signals:
                count[c] = count.get(c, 0) + 1
                heap = blocked.get(c)
                while heap and heap[0][0] <= count[c]:
                    _, j = heapq.heappop(heap)
                    missing[j] -= 1
                    if not missing[j]:
                        push(j)
        if done != len(self.tasks):
            stuck = [self.tasks[i][0] for i in range(len(self.tasks))
                     if missing[i]][:4]
            raise AssertionError(f"deadlock: {len(self.tasks) - done} tasks "
                                 f"wait forever, e.g. {stuck}")
