"""A one-entry cache of a table built from tensors: kept for the last
object seen while its source tensors are alive and unmodified (same
objects, same in-place version counters)."""

from __future__ import annotations

import weakref


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
            return last[2]
        out = build(obj)
        get.last = ([weakref.ref(x) for x in src], versions, out)
        return out
    get.last = None
    return get
