"""
Caching utilities: cached attributes, functions, methods, and cached-instance
classes (spectral bases are singletons per canonicalized constructor args).

Parity target: dedalus/tools/cache.py:14,39,92,111 (fresh implementation).
"""

import types
from functools import partial


class CachedAttribute:
    """Descriptor that computes an attribute once per instance and stores it."""

    def __init__(self, method):
        self.method = method
        self.__name__ = method.__name__
        self.__doc__ = method.__doc__

    def __get__(self, instance, owner):
        if instance is None:
            return self
        value = self.method(instance)
        instance.__dict__[self.__name__] = value
        return value


def _freeze(item):
    """Canonicalize an argument into a hashable key."""
    if isinstance(item, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in item.items()))
    if isinstance(item, (list, tuple)):
        return tuple(_freeze(i) for i in item)
    if isinstance(item, set):
        return frozenset(_freeze(i) for i in item)
    try:
        import numpy as np
        if isinstance(item, np.ndarray):
            return (item.shape, str(item.dtype), item.tobytes())
    except ImportError:
        pass
    return item


class CachedFunction:
    """Memoizing function wrapper with canonicalized args."""

    def __init__(self, function, max_size=None):
        self.function = function
        self.cache = {}
        self.__name__ = getattr(function, '__name__', 'cached')
        self.__doc__ = getattr(function, '__doc__', None)

    def __call__(self, *args, **kw):
        key = (_freeze(args), _freeze(kw))
        try:
            return self.cache[key]
        except KeyError:
            value = self.function(*args, **kw)
            self.cache[key] = value
            return value
        except TypeError:
            # Unhashable: skip caching
            return self.function(*args, **kw)


class CachedMethod:
    """Memoizing method descriptor (per-instance cache)."""

    def __init__(self, method):
        self.method = method
        self.__name__ = method.__name__
        self.__doc__ = method.__doc__

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = CachedFunction(partial(self.method, instance))
        bound.__name__ = self.__name__
        instance.__dict__[self.__name__] = bound
        return bound


class CachedClass(type):
    """Metaclass caching instances per canonicalized constructor arguments."""

    def __init__(cls, *args, **kw):
        super().__init__(*args, **kw)
        cls._instance_cache = {}

    def __call__(cls, *args, **kw):
        key = (_freeze(args), _freeze(kw))
        try:
            return cls._instance_cache[key]
        except KeyError:
            instance = super().__call__(*args, **kw)
            cls._instance_cache[key] = instance
            return instance
        except TypeError:
            return super().__call__(*args, **kw)
