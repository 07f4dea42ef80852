"""
The step program: one timestep on static buffers, captured as a CUDA graph
and replayed (kernel K15 of the ROADMAP).

Mirrors the JAX package's whole-run programs
(dedalus_tpu/core/timesteppers.py:495-747 `_build_compiled` and
`_run_compiled`, :952-1030 the RK forms): there a jit around a fori_loop
carries t, the history rings and the state on the device, and the host
makes no round trip between steps. Here a timestepper's step reads and
writes only static buffers, those of `StepProgram` (the flat state, the
clock t, the coefficient vector, the external RHS fields' data) and the
timestepper's own (the history rings), so one step can be captured into a
`torch.cuda.CUDAGraph` and replayed n times. The step's own temporaries
live in one memory pool shared by all of a timestepper's graphs: every one
of them is dead at the end of its step.

A graph belongs to the cache it is stored in (`GraphCache`), which lives
on the factorization that it solves with (the multistep schemes) or on the
step size's stage entry (RK): a graph holds that factorization's addresses
and is dropped with it. The first step through a cache runs eagerly (it
uploads the transform matrices, compiles the Triton kernels and builds
every lazily made device table the step reads); the graphs of its keys are
captured after it. A capture that fails raises.

On the CPU, and on the card where the timestepper's private `_eager` is
set (the check of graph against eager), the same step runs eagerly.
"""

import torch

from ..csrc import build


class GraphCache:
    """The captured steps of one factorization (or RK step size), by key."""

    def __init__(self):
        self.warm = False
        # key -> (CUDAGraph, build.Capture of its launches)
        self.graphs = {}


def graph_cache(owner):
    """The GraphCache stored on `owner` (made at first use)."""
    cache = getattr(owner, '_step_graphs', None)
    if cache is None:
        cache = owner._step_graphs = GraphCache()
    return cache


class StepProgram:
    """
    The static buffers of one timestepper's step and the replay of its
    captured graphs.

    state: the flat coefficient state the step reads and overwrites;
    t: the simulation time, a 0-d float64 tensor the step advances;
    coef: the multistep scheme's (3 s,) coefficient vector (K7's);
    rhs_prev: poly's carried right-hand side;
    ext: the data of the RHS trees' external fields (forcing fields and
    the like), copied in at each load, so that a graph reads the data the
    fields hold at that time.
    """

    def __init__(self, solver, coef_size=0):
        self.solver = solver
        dev = solver.dist.device
        self.device = dev
        self.t = torch.zeros((), dtype=torch.float64, device=dev)
        self.coef = torch.zeros(coef_size, dtype=torch.float64, device=dev)
        self.state = None
        self.rhs_prev = None
        self._ext = {}
        self._loaded = []
        self.pool = None
        # Captures and replays made (all keys)
        self.captures = 0
        self.replays = 0

    # --- buffers ---

    def load(self, state_flat, t):
        """Copy the state and time in, and bind each external RHS field to
        its static buffer (holding the field's present data) until
        `unload`. Returns the key part that the buffers' layout sets."""
        if self.state is None or self.state.shape != state_flat.shape:
            self.state = torch.empty_like(state_flat)
        self.state.copy_(state_flat)
        self.t.fill_(float(t))
        sig = []
        self._loaded = []
        for f in self.solver._rhs_external_fields():
            buf = self._ext.get(id(f))
            if buf is None or buf.shape != f.data.shape or buf.dtype != f.data.dtype:
                buf = self._ext[id(f)] = torch.empty_like(f.data,
                                                          memory_format=torch.contiguous_format)
            buf.copy_(f.data)
            self._loaded.append((f, f.data))
            f.data = buf
            sig.append((id(f), tuple(f.layout.grid_space), tuple(f.scales), buf.data_ptr()))
        return tuple(sig)

    def unload(self):
        """The state after the steps (a copy: no field aliases a buffer that
        a later replay overwrites); the external fields get their own data
        back."""
        for f, data in self._loaded:
            f.data = data
        self._loaded = []
        return self.state.clone()

    def carried_rhs(self, like):
        """poly's carried right-hand side buffer, shaped as `like`."""
        if self.rhs_prev is None or self.rhs_prev.shape != like.shape:
            self.rhs_prev = torch.empty_like(like)
        return self.rhs_prev

    # --- running ---

    def run(self, cache, key, body, eager=False):
        """One step: body() eagerly on the CPU, where `eager` is set, or at
        the first step through `cache`; else the replay of cache's graph
        for `key`, captured at its first use."""
        if eager or self.device.type != 'cuda' or not cache.warm:
            body()
            cache.warm = True
            return
        entry = cache.graphs.get(key)
        if entry is None:
            entry = cache.graphs[key] = self._capture(body)
        graph, counts = entry
        graph.replay()
        counts.replayed()
        self.replays += 1

    def _capture(self, body):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with build.Capture() as counts:
            with torch.cuda.graph(graph, pool=self.pool):
                body()
        self.captures += 1
        return graph, counts
