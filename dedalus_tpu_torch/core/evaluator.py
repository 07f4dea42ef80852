"""
Evaluator: scheduled evaluation of analysis tasks.

Mirrors dedalus_tpu/core/evaluator.py: Task, the Handler schedule (wall
time, sim time, iteration and custom cadences) and the DictionaryHandler,
whose outputs stay as Fields on the distributor's device. HDF5 file
handlers are not ported yet (ROADMAP M9).
"""

from .future import Future


class Task:
    __slots__ = ('operand', 'name', 'layout', 'scales', 'out')

    def __init__(self, operand, name, layout='g', scales=1):
        self.operand = operand
        self.name = name
        self.layout = layout
        self.scales = scales
        self.out = None


class Handler:
    """Scheduled group of output tasks."""

    def __init__(self, evaluator, wall_dt=None, sim_dt=None, iter=None, custom_schedule=None):
        self.evaluator = evaluator
        self.tasks = []
        self.wall_dt = wall_dt
        self.sim_dt = sim_dt
        self.iter = iter
        self.custom_schedule = custom_schedule
        self.last_wall_div = -1
        self.last_sim_div = -1
        self.last_iter_div = -1

    def add_task(self, task, name=None, layout='g', scales=None):
        if isinstance(task, str):
            namespace = dict(self.evaluator.namespace)
            task_op = eval(task, namespace)
            name = name or task
        else:
            task_op = task
            name = name or getattr(task, 'name', None) or f"task{len(self.tasks)}"
        if scales is None:
            scales = 1
        self.tasks.append(Task(task_op, name, layout, scales))

    def check_schedule(self, wall_time=0.0, sim_time=0.0, iteration=0, **kw):
        scheduled = False
        if self.wall_dt is not None:
            div = int(wall_time // self.wall_dt)
            if div > self.last_wall_div:
                scheduled = True
                self.last_wall_div = div
        if self.sim_dt is not None:
            div = int((sim_time + 1e-12) // self.sim_dt)
            if div > self.last_sim_div:
                scheduled = True
                self.last_sim_div = div
        if self.iter is not None:
            div = iteration // self.iter
            if div > self.last_iter_div:
                scheduled = True
                self.last_iter_div = div
        if self.custom_schedule is not None:
            scheduled = scheduled or self.custom_schedule(
                wall_time=wall_time, sim_time=sim_time, iteration=iteration, **kw)
        return scheduled

    def process(self, **kw):
        raise NotImplementedError


class DictionaryHandler(Handler):
    """Stores outputs in a dict of Fields."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.fields = {}

    def __getitem__(self, name):
        return self.fields[name]

    def process(self, **kw):
        for task in self.tasks:
            out = task.operand.evaluate() if isinstance(task.operand, Future) else task.operand
            if task.layout in ('g', 'grid'):
                out.change_scales(task.scales)
                out.require_grid_space()
            else:
                out.require_coeff_space()
            task.out = out
            self.fields[task.name] = out


class Evaluator:
    """Coordinates handler scheduling."""

    def __init__(self, dist, namespace=None):
        self.dist = dist
        self.namespace = namespace or {}
        self.handlers = []

    def add_dictionary_handler(self, **kw):
        handler = DictionaryHandler(self, **kw)
        self.handlers.append(handler)
        return handler

    def add_file_handler(self, base_path, **kw):
        raise NotImplementedError("file handlers (HDF5 output) are not ported yet "
                                  "(ROADMAP M9)")

    def evaluate_scheduled(self, **kw):
        for handler in self.handlers:
            if handler.check_schedule(**kw):
                handler.process(**kw)
