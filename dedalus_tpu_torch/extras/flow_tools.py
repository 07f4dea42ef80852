"""
Flow analysis tools: global reductions, flow properties, and CFL timestep
control.

Mirrors dedalus_tpu/extras/flow_tools.py. Reductions run on the device
over the handler's field data; only scalars cross to the host. The CFL
maximum frequency is evaluated on the current state: the registered
frequency expressions are evaluated eagerly (plain torch), and their
summed global max is kernel KD (csrc/cfl_max.py).
"""

import numpy as np
import torch

from ..core.future import Future
from ..csrc.cfl_max import cfl_max


class GlobalArrayReducer:
    """Global reductions over (serial) device data; only the scalar is
    transferred."""

    def __init__(self, comm=None, dtype=np.float64):
        self.dtype = dtype

    def reduce_scalar(self, value, op=None):
        return float(value)

    def global_min(self, data, empty=np.inf):
        return float(torch.min(data)) if data.numel() else empty

    def global_max(self, data, empty=-np.inf):
        return float(torch.max(data)) if data.numel() else empty

    def global_mean(self, data):
        return float(torch.mean(data))


class GlobalFlowProperty:
    """
    Scheduled evaluation of scalar diagnostics over the flow. Usage:
        flow = GlobalFlowProperty(solver, cadence=10)
        flow.add_property(np.sqrt(u@u)/nu, name='Re')
        ... flow.max('Re')
    Reductions run on the device over the handler's stored fields.
    """

    def __init__(self, solver, cadence=1):
        self.solver = solver
        self.cadence = cadence
        self.reducer = GlobalArrayReducer()
        self.properties = {}
        self.handler = solver.evaluator.add_dictionary_handler(iter=cadence)

    def add_property(self, property, name):
        self.handler.add_task(property, name=name, layout='g')

    def _grid_data(self, name):
        return self.handler[name].data

    def max(self, name):
        return self.reducer.global_max(self._grid_data(name))

    def min(self, name):
        return self.reducer.global_min(self._grid_data(name))

    def grid_average(self, name):
        return self.reducer.global_mean(self._grid_data(name))

    def volume_integral(self, name):
        raise NotImplementedError("volume integrals (basis quadrature weights) are "
                                  "not ported yet (ROADMAP M9)")

    def volume_average(self, name):
        return self.volume_integral(name)


class CFL:
    """
    Advective CFL timestep controller. Frequencies are summed per grid point
    across all registered velocities/frequencies, and the timestep is the
    reciprocal of the maximum total frequency, scaled by `safety` and
    clamped by max/min dt and fractional change. `quantize` (ratio > 1)
    snaps each timestep down onto the geometric grid {quantize^k}, so an
    adaptive run visits a bounded set of step sizes (and factorizations).
    """

    def __init__(self, solver, initial_dt, cadence=1, safety=1.0, max_dt=np.inf,
                 min_dt=0.0, max_change=np.inf, min_change=0.0, threshold=0.0,
                 quantize=0.0):
        self.solver = solver
        self.initial_dt = initial_dt
        self.cadence = cadence
        self.safety = safety
        self.max_dt = max_dt
        self.min_dt = min_dt
        self.max_change = max_change
        self.min_change = min_change
        self.threshold = threshold
        if quantize and not quantize > 1.0:
            raise ValueError("quantize must be a ratio > 1 (e.g. 2**0.25)")
        self.quantize = float(quantize) if quantize else 0.0
        if self.quantize and initial_dt > 0 and np.isfinite(initial_dt):
            initial_dt = self._snap(initial_dt)
            self.initial_dt = initial_dt
        self.stored_dt = initial_dt
        self._freq_ops = []

    def add_velocity(self, velocity):
        """Grid-crossing frequencies of a velocity vector."""
        from ..core.operators import AdvectiveCFL
        if len(velocity.tensorsig) != 1:
            raise ValueError("Velocity must be a vector")
        self.add_frequency(AdvectiveCFL(velocity, velocity.tensorsig[0]))

    def add_frequency(self, freq):
        """Register an additional on-grid frequency expression."""
        self._freq_ops.append(freq)

    def frequency_grids(self):
        """The registered frequencies on the current state, as contiguous
        grid data at their dealias scales."""
        grids = []
        for op in self._freq_ops:
            f = op.evaluate() if isinstance(op, Future) else op
            f.change_scales(f.domain.dealias)
            f.require_grid_space()
            grids.append(f.data.contiguous())
        return grids

    def max_frequency(self):
        """Current global max of the summed frequencies."""
        return float(cfl_max(self.frequency_grids()))

    def compute_timestep(self):
        """New timestep: frequencies are summed per grid point before
        reciprocating, evaluated on the current state."""
        iteration = self.solver.iteration
        if (iteration - 1) % self.cadence == 0:
            if (iteration - 1) <= self.solver.initial_iteration:
                return self.stored_dt
            fmax = self.max_frequency()
            dt = np.inf if fmax == 0.0 else 1.0 / fmax
            dt *= self.safety
            dt = min(dt, self.max_dt, self.max_change * self.stored_dt)
            dt = max(dt, self.min_dt, self.min_change * self.stored_dt)
            if self.quantize and dt > 0 and np.isfinite(dt):
                dt = self._snap(dt)
            if abs(dt - self.stored_dt) > self.threshold * self.stored_dt:
                self.stored_dt = dt
        return self.stored_dt

    def _snap(self, dt):
        """Snap dt down onto the geometric grid {quantize^k}."""
        lr = np.log(self.quantize)
        return float(np.exp(lr * np.floor(np.log(dt) / lr + 1e-12)))

    def chunk_steps(self, max_n=None):
        """Number of steps to advance before the next scheduled CFL update
        (bounded by the solver's stop criteria), for the chunked main loop:
            dt = cfl.compute_timestep(); solver.run_steps(dt, cfl.chunk_steps())"""
        solver = self.solver
        it = solver.iteration
        n = (-(it - 1)) % self.cadence or self.cadence
        if np.isfinite(solver.stop_iteration):
            n = min(n, max(1, int(solver.stop_iteration - it)))
        if np.isfinite(solver.stop_sim_time) and self.stored_dt > 0:
            remaining = solver.stop_sim_time - solver.sim_time
            n = min(n, max(1, int(np.ceil(remaining / self.stored_dt - 1e-9))))
        if max_n is not None:
            n = min(n, max_n)
        return max(1, n)
