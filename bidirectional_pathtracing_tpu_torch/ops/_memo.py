"""A one-entry cache of a table built from tensors: kept for the last
object seen while its source tensors are alive and unmodified (same
objects, same in-place version counters).

A CUDA graph captured over a launch that read such a table keeps the
table's address, while the cache drops the table as soon as another
object is seen.  holding() hands the graph's owner every table returned
inside it (utils/step_graph.py), so that the owner keeps them alive."""

from __future__ import annotations

import contextlib
import weakref

_holders: list = []


@contextlib.contextmanager
def holding():
    """Yields a dict that collects, by id, every table that a last_of cache
    returns inside the block."""
    held = {}
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.remove(held)


def last_of(sources, build):
    """get(obj) -> build(obj), built again only when sources(obj), a tuple
    of tensors, is not the last one seen or one of them was modified in
    place.  get.last holds the cached entry."""
    def get(obj):
        src = sources(obj)
        versions = tuple(x._version for x in src)
        last = get.last
        if (last is not None and last[1] == versions and len(last[0]) == len(src)
                and all(ref() is x for ref, x in zip(last[0], src))):
            out = last[2]
        else:
            out = build(obj)
            get.last = ([weakref.ref(x) for x in src], versions, out)
        for held in _holders:
            held[id(out)] = out
        return out
    get.last = None
    return get
