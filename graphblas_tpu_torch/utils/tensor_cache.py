"""A cache of values computed from tensors, valid while those tensors live.

The SpGEMM prep and triangle counting's L, L' are pure in their operands'
arrays and costly to rebuild, so they are kept per operand (the
hyper-hash idiom, GB_hyper_hash_build.c).  An entry is keyed by the
identities of the tensors it was computed from and holds only weak
references to them: a lookup answers only while every one is the same
live object, and the entry is dropped the moment any of them is freed,
so a later tensor that reuses a freed one's ``id`` never sees a stale
value, and what the entry holds (often device memory) goes with its
operands.  At most ``size`` entries; the oldest goes first.  The value
must not hold the key tensors themselves, or they would never be freed.
"""

from __future__ import annotations

import weakref


class TensorCache:
    def __init__(self, size: int):
        self.size = size
        self._ents: dict = {}   # key -> (weak refs, finalizers, value)

    @staticmethod
    def _key(tensors, extra):
        return tuple(map(id, tensors)) + tuple(extra)

    def get(self, tensors, extra=()):
        """The value stored for exactly these live tensors, else None."""
        ent = self._ents.get(self._key(tensors, extra))
        if ent is None or any(r() is not t for r, t in zip(ent[0], tensors)):
            return None
        return ent[2]

    def put(self, tensors, extra, value):
        key = self._key(tensors, extra)
        self._drop(key)
        while len(self._ents) >= self.size:
            self._drop(next(iter(self._ents)))
        self._ents[key] = ([weakref.ref(t) for t in tensors],
                           [weakref.finalize(t, self._drop, key)
                            for t in tensors], value)
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
