"""The port's scheduler (shaderflow_tpu_torch/scheduler.py) against the JAX
package's under one scripted clock: the same task calls in the same order
with the same dt values, with frameskip on and off, once tasks first, and
all_once, in realtime (sleeping) and freewheel modes."""

import types

import numpy as np
import pytest

from shaderflow_tpu import scheduler as reference
from shaderflow_tpu_torch import scheduler as port


class ScriptedClock:
    """time.monotonic / time.sleep / time.perf_counter on a virtual clock:
    sleeping advances it, and so does a task's scripted work."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self) -> float:
        self.now += 1e-6     # a spin loop makes progress
        return self.now

    perf_counter = monotonic

    def sleep(self, seconds: float) -> None:
        self.now += max(0.0, seconds)


def _drive(module, monkeypatch, frameskip: bool, freewheel: bool, ticks: int = 40):
    """Run one script -> [(task, dt or None)] in call order."""
    clock = ScriptedClock()
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        monotonic=clock.monotonic, sleep=clock.sleep, perf_counter=clock.perf_counter))
    rng = np.random.default_rng(7)
    costs = rng.uniform(0.0, 0.05, size=ticks)   # up to three 60 fps periods of work
    log = []
    scheduler = module.Scheduler()
    tick = {"n": 0}

    def frame(dt):
        log.append(("frame", round(dt, 9)))
        clock.now += float(costs[tick["n"] % ticks])
        tick["n"] += 1
        if tick["n"] in (5, 17):
            scheduler.once(lambda: log.append(("once", None)), freewheel=freewheel)
        if tick["n"] == 23:
            scheduler.once(lambda dt: log.append(("once-dt", round(dt, 9))),
                           freewheel=freewheel)
            scheduler.once(lambda: log.append(("once-b", None)), freewheel=freewheel)
            scheduler.all_once()

    def slow(dt):
        log.append(("slow", round(dt, 9)))

    scheduler.new(frame, frequency=60, frameskip=frameskip, freewheel=freewheel,
                  precise=True)
    scheduler.new(slow, frequency=7, frameskip=frameskip, freewheel=freewheel)
    for _ in range(ticks):
        scheduler.next()
    return log, [task.next_call - task.started for task in scheduler.tasks]


@pytest.mark.parametrize("freewheel", [False, True], ids=["realtime", "freewheel"])
@pytest.mark.parametrize("frameskip", [True, False], ids=["frameskip", "capped"])
def test_scheduler_matches_reference(monkeypatch, frameskip, freewheel):
    want, want_next = _drive(reference, monkeypatch, frameskip, freewheel)
    got, got_next = _drive(port, monkeypatch, frameskip, freewheel)
    assert got == want
    np.testing.assert_allclose(got_next, want_next, rtol=0, atol=1e-9)
    kinds = [name for name, _ in got]
    assert "once" in kinds and "once-dt" in kinds and "slow" in kinds
    frames = [dt for name, dt in got if name == "frame"]
    if not frameskip:
        # dt never exceeds one period with frameskip off
        assert max(frames) <= 1 / 60 + 1e-9
    elif not freewheel:
        # scripted work longer than a period shows up as a longer dt
        assert max(frames) > 1 / 60 + 1e-3


def test_once_tasks_sort_first_and_vanish():
    for module in (reference, port):
        order = []
        scheduler = module.Scheduler()
        scheduler.new(lambda: order.append("recurring"), frequency=1000, freewheel=True)
        scheduler.once(lambda: order.append("once"), freewheel=True)
        scheduler.next()
        scheduler.next()
        assert order == ["once", "recurring"]
        assert [task.once for task in scheduler.tasks] == [False]
