"""
Chunked, layout-independent random array generation.

Parity target (behavior): dedalus/tools/random_arrays.py (ChunkedRandomArray)
and dedalus/core/field.py:898-943 (fill_random): random fields must be
deterministic functions of (seed, global shape) alone — identical no matter
how the data is distributed over a device mesh, and computable one local
shard at a time without materializing the global array.

Fresh design: instead of the reference's sequential chunk iteration (chunk i
requires drawing chunks 0..i-1), each chunk's generator is seeded from an
independently spawned SeedSequence child keyed by the chunk index. Any shard
of the global array is then O(local size) to produce — the right scaling for
large distributed fields.
"""

import numpy as np

DEFAULT_CHUNK = 2 ** 20  # 8 MB of float64 per chunk


class ChunkedRandomArray:
    """
    A virtual random array of a fixed global shape whose elements are produced
    deterministically when indexed. Slicing any region yields the same values
    as slicing the materialized whole.

    Parameters
    ----------
    shape : tuple of ints
        Global shape.
    seed : int or None
        RNG seed (None draws fresh OS entropy — not reproducible).
    chunk_size : int
        Flat elements per chunk (bounds the working memory per draw).
    distribution : str
        numpy Generator method name ('uniform', 'normal', 'standard_normal', ...).
    **kw :
        Keywords for the distribution method.
    """

    def __init__(self, shape, seed=None, chunk_size=DEFAULT_CHUNK,
                 distribution='uniform', **kw):
        self.shape = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)
        self.size = int(np.prod(self.shape)) if self.shape else 1
        self.seed = seed
        self.chunk_size = int(chunk_size)
        self.distribution = distribution
        self.kw = kw
        self._root = np.random.SeedSequence(seed)

    def _chunk(self, index):
        """Draw chunk `index` of the global flat stream."""
        child = np.random.SeedSequence(
            entropy=self._root.entropy, spawn_key=(index,))
        rng = np.random.default_rng(child)
        n = min(self.chunk_size, self.size - index * self.chunk_size)
        return getattr(rng, self.distribution)(size=n, **self.kw)

    def flat_values(self, flat_indices):
        """Values of the global stream at the given flat indices."""
        flat_indices = np.asarray(flat_indices)
        if flat_indices.size == 0:
            return np.zeros(flat_indices.shape)
        div, mod = np.divmod(flat_indices, self.chunk_size)
        values = None
        for chunk_index in np.unique(div):
            data = self._chunk(int(chunk_index))
            if values is None:
                values = np.zeros(flat_indices.shape, dtype=data.dtype)
            sel = (div == chunk_index)
            values[sel] = data[mod[sel]]
        return values

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) < self.ndim:
            key = key + (slice(None),) * (self.ndim - len(key))
        if len(key) > self.ndim:
            raise ValueError("Too many selections")
        key = tuple(slice(*k.indices(s)) if isinstance(k, slice) else k
                    for k, s in zip(key, self.shape))
        grids = np.mgrid[key]
        flat = np.ravel_multi_index(grids, self.shape)
        return self.flat_values(flat)

    def materialize(self):
        """The full global array (convenience for serial callers)."""
        return self[(slice(None),) * self.ndim]


def chunked_random_field(shape, seed, distribution='standard_normal',
                         dtype=np.float64, chunk_size=DEFAULT_CHUNK, **kw):
    """
    Global random array of `shape` and `dtype`, deterministic in
    (seed, shape). Complex dtypes draw a trailing re/im pair from the same
    stream, so real and complex fields stay layout-independent.
    """
    if distribution == 'normal' and 'loc' not in kw and 'scale' not in kw:
        distribution = 'standard_normal'
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        draw = ChunkedRandomArray(tuple(shape) + (2,), seed=seed,
                                  chunk_size=chunk_size,
                                  distribution=distribution, **kw)
        pair = draw.materialize()
        return (pair[..., 0] + 1j * pair[..., 1]).astype(dtype)
    draw = ChunkedRandomArray(shape, seed=seed, chunk_size=chunk_size,
                              distribution=distribution, **kw)
    return draw.materialize().astype(dtype)
