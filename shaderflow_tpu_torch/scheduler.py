"""
Cooperative single-thread task scheduler: the realtime preview's pacing.

Port of shaderflow_tpu/scheduler.py: frequency-driven tasks with a
freewheel mode (no sleeping, exact virtual frame times), frameskip (with
frameskip off, dt is capped to one period), spin-precise sleeping for
realtime, dt= injected into tasks that take it, and 'once' tasks that sort
first (hot-reload recompiles are marshalled onto the main thread through
them; Scheduler.all_once runs them at a frame's start).

The export loop never ticks it: frames render in batches (scene.py). The
realtime loop (ShaderScene.main without an output) runs one task, the
frame, at the scene's fps.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Iterable, Optional


def precise_sleep(duration: float, *, slack: float = 0.001) -> None:
    """Sleep with a short thread-spin tail for low-jitter frame pacing."""
    start = time.monotonic()
    coarse = duration - slack
    if coarse <= 0:
        return
    time.sleep(coarse)
    while (time.monotonic() - start) < duration:
        pass


class SchedulerTask:

    def __init__(
        self,
        task: Callable,
        *,
        args: Optional[list] = None,
        kwargs: Optional[dict] = None,
        frequency: float = 60.0,
        frameskip: bool = True,
        freewheel: bool = False,
        precise: bool = False,
        once: bool = False,
        enabled: bool = True,
    ):
        self.task = task
        self.args = args or []
        self.kwargs = kwargs or {}
        self.frequency = float(frequency)
        self.frameskip = frameskip
        self.freewheel = freewheel
        self.precise = precise
        self.once = once
        self.enabled = enabled
        self.output: Any = None

        # Freewheel runs on an idealized clock starting at zero
        self.started = 0.0 if freewheel else time.monotonic()
        self.last_call = self.started - self.period
        self.next_call = self.started

        self._wants_dt = "dt" in inspect.signature(task).parameters

    # -- properties ---------------------------------------------------------

    @property
    def fps(self) -> float:
        return self.frequency

    @fps.setter
    def fps(self, value: float) -> None:
        self.frequency = float(value)

    @property
    def period(self) -> float:
        return 1.0 / self.frequency

    @period.setter
    def period(self, value: float) -> None:
        self.frequency = 1.0 / value

    @property
    def should_delete(self) -> bool:
        return self.once and not self.enabled

    # -- ordering: 'once' tasks run first, then earliest next_call ----------

    def __lt__(self, other: "SchedulerTask") -> bool:
        if self.once and not other.once:
            return True
        if other.once and not self.once:
            return False
        return self.next_call < other.next_call

    # -- execution ----------------------------------------------------------

    def next(self, block: bool = True) -> "SchedulerTask":
        if not self.freewheel:
            wait = max(0.0, self.next_call - time.monotonic())
            if wait > 0 and not block:
                return self
            if self.precise:
                precise_sleep(wait)
            elif wait:
                time.sleep(wait)

        now = self.next_call if self.freewheel else time.monotonic()

        if self._wants_dt:
            dt = now - self.last_call
            if not self.frameskip:
                dt = min(dt, self.period)
            self.kwargs["dt"] = dt

        self.last_call = now
        self.output = self.task(*self.args, **self.kwargs)

        while self.next_call <= now:
            self.next_call += self.period

        self.enabled = not self.once
        return self


class Scheduler:
    Task = SchedulerTask

    def __init__(self) -> None:
        self.tasks: list[SchedulerTask] = []

    def add(self, task: SchedulerTask) -> SchedulerTask:
        self.tasks.append(task)
        return task

    def new(self, task: Callable, **options) -> SchedulerTask:
        return self.add(SchedulerTask(task, **options))

    def once(self, task: Callable, **options) -> SchedulerTask:
        return self.add(SchedulerTask(task, once=True, **options))

    def delete(self, task: SchedulerTask) -> None:
        self.tasks.remove(task)

    def clear(self) -> None:
        self.tasks.clear()

    @property
    def enabled_tasks(self) -> Iterable[SchedulerTask]:
        return (task for task in self.tasks if task.enabled)

    @property
    def next_task(self) -> Optional[SchedulerTask]:
        return min(self.enabled_tasks, default=None)

    def _prune(self) -> None:
        self.tasks = [task for task in self.tasks if not task.should_delete]

    def next(self, block: bool = True) -> Optional[SchedulerTask]:
        task = self.next_task
        if task is None:
            return None
        try:
            return task.next(block=block)
        finally:
            if task.should_delete:
                self._prune()

    def all_once(self) -> None:
        """Run every pending 'once' task now (main-thread marshalling point)."""
        for task in list(self.tasks):
            if task.once and task.enabled:
                task.next()
        self._prune()
