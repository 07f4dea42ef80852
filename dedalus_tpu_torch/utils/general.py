"""
General helpers: ordered sets, oscillation iterators, attribute unification.

Parity target: dedalus/tools/general.py (fresh implementation).
"""


class OrderedSet:
    """Set preserving insertion order (backed by dict)."""

    def __init__(self, iterable=()):
        self._d = dict.fromkeys(iterable)

    def add(self, item):
        self._d[item] = None

    def update(self, iterable):
        for i in iterable:
            self._d[i] = None

    def discard(self, item):
        self._d.pop(item, None)

    def __contains__(self, item):
        return item in self._d

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def __repr__(self):
        return f"OrderedSet({list(self._d)})"


def oscillate(start, stop):
    """Generate indices bouncing between [start, stop): start..stop-1..start.. forever."""
    index = start
    direction = 1
    while True:
        yield index
        if stop - start <= 1:
            continue
        if index == stop - 1:
            direction = -1
        elif index == start:
            direction = 1
        index += direction


def unify(objects):
    """Check that all objects in an iterable are equal and return the value."""
    objects = list(objects)
    first = objects[0]
    for other in objects[1:]:
        if other != first:
            raise ValueError(f"Objects are not all equal: {first} vs {other}")
    return first


def unify_attributes(objects, attr, require=True):
    """Unify an attribute across objects; optionally skip objects lacking it."""
    values = []
    for obj in objects:
        if hasattr(obj, attr):
            values.append(getattr(obj, attr))
        elif require:
            raise AttributeError(f"{obj} has no attribute {attr}")
    return unify(values)


def is_real_dtype(dtype):
    import numpy as np
    return np.issubdtype(np.dtype(dtype), np.floating)


def is_complex_dtype(dtype):
    import numpy as np
    return np.issubdtype(np.dtype(dtype), np.complexfloating)


def prod(iterable):
    out = 1
    for i in iterable:
        out = out * i
    return out


class DeferredTuple:
    """Sequence whose entries are computed on first access from an entry
    function (parity: tools/general.py:94 DeferredTuple)."""

    def __init__(self, entry_function, size):
        self.entry_function = entry_function
        self.size = int(size)
        self._cache = {}

    def __getitem__(self, key):
        if isinstance(key, slice):
            return tuple(self[i] for i in range(*key.indices(self.size)))
        if key < 0:
            key += self.size
        if not 0 <= key < self.size:
            raise IndexError("DeferredTuple index out of range")
        if key not in self._cache:
            self._cache[key] = self.entry_function(key)
        return self._cache[key]

    def __len__(self):
        return self.size

    def __iter__(self):
        return (self[i] for i in range(self.size))
