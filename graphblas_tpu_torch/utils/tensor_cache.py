"""A cache of values computed from tensors, valid while those tensors live
and stay unwritten.

The SpGEMM prep, triangle counting's L, L' and a sparse matrix's flip to
the other orientation are pure in their operands' arrays and costly to
rebuild, so they are kept per operand (the hyper-hash idiom,
GB_hyper_hash_build.c; LAGraph keeps a graph's transpose, G->AT, the same
way).  An entry is keyed by the identities of the tensors it was computed
from and holds only weak references to them: a lookup answers only while
every one is the same live object, and the entry is dropped the moment
any of them is freed, so a later tensor that reuses a freed one's ``id``
never sees a stale value, and what the entry holds (often device memory)
goes with its operands.  It also records torch's in-place write counter
(``Tensor._version``) of the key tensors and of the tensors of the value
that a caller may be handed (``held``): a lookup after an in-place write
to any of them drops the entry and misses.  Inference tensors keep no
such counter, so nothing computed from one is kept.  At most ``size``
entries; the oldest goes first.  The value must not hold the key tensors
themselves, or they would never be freed.
"""

from __future__ import annotations

import weakref


def _versions(tensors):
    """The in-place write counters of ``tensors``, or None where one is an
    inference tensor (which has none)."""
    if any(t.is_inference() for t in tensors):
        return None
    return tuple(t._version for t in tensors)


class TensorCache:
    def __init__(self, size: int):
        self.size = size
        # key -> (weak refs, finalizers, value, held, write counters)
        self._ents: dict = {}

    @staticmethod
    def _key(tensors, extra):
        return tuple(map(id, tensors)) + tuple(extra)

    def get(self, tensors, extra=()):
        """The value stored for exactly these live tensors, none of them
        nor the value's ``held`` tensors written in place since, else
        None."""
        key = self._key(tensors, extra)
        ent = self._ents.get(key)
        if ent is None or any(r() is not t for r, t in zip(ent[0], tensors)):
            return None
        if _versions(list(tensors) + ent[3]) != ent[4]:
            self._drop(key)
            return None
        return ent[2]

    def put(self, tensors, extra, value, held=()):
        """Keep ``value`` for ``tensors``; ``held``: the tensors of the
        value that callers are handed, whose in-place writes void it."""
        key = self._key(tensors, extra)
        self._drop(key)
        held = list(held)
        vers = _versions(list(tensors) + held)
        if vers is None:
            return value
        while len(self._ents) >= self.size:
            self._drop(next(iter(self._ents)))
        self._ents[key] = ([weakref.ref(t) for t in tensors],
                           [weakref.finalize(t, self._drop, key)
                            for t in tensors], value, held, vers)
        return value

    def _drop(self, key):
        ent = self._ents.pop(key, None)
        if ent is not None:
            for f in ent[1]:
                f.detach()

    def clear(self):
        for key in list(self._ents):
            self._drop(key)

    def __len__(self):
        return len(self._ents)
