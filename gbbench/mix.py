"""The general traffic generator: reads ``traffic/<mix>.json`` and makes
the calls of a closed loop from the seed.

A mix is data: ``call`` names ``calls/<call>.py``, which makes one call of
the program's public entry of that name (``inputs(edges, cfg, seed)``
draws what each call gets besides the matrix, and the warm call's own;
``call(A, key, kwargs)`` makes the call and returns its answer);
``kwargs`` are the entry's parameters, which the reference gets too;
``reference`` names ``reference/<name>.py``; ``sample`` is how many calls
of the window it judges, drawn from the seed; ``spmv_values`` says whether
the mix's SpMVs need the matrix's values (a weighted semiring) or only its
pattern; ``limits`` holds the limit of each number the reference
compares."""

from __future__ import annotations

import random

from . import catalog, graph


class Mix:
    def __init__(self, traffic: dict, cfg: dict, edges: graph.Edges,
                 seed: int):
        self.traffic = traffic
        self.calls = catalog.module("calls", traffic["call"])
        self.kwargs = dict(traffic.get("kwargs", {}))
        self.keys, self.warm = self.calls.inputs(edges, cfg, seed)
        self.sampler = random.Random(catalog.derive(seed, "sample"))

    def key(self, i: int):
        """The input of call ``i`` (-1: the warm call's own)."""
        return self.warm if i < 0 else self.keys[i % len(self.keys)]

    def call(self, A, i: int):
        return self.calls.call(A, self.key(i), self.kwargs)


class Reservoir:
    """A uniform sample of ``size`` of the calls offered, drawn by ``rng``
    (the same calls for the same seed and count)."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng = size, rng
        self.kept: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.kept[j] = item
