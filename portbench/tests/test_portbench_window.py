"""The window's rate arithmetic and the benchmark's sink, on made-up
timestamps and frames."""

import types

import numpy as np
import pytest

from portbench.harness.window import BenchSink, Delivery, Window, export_fps


def test_rate_counts_frames_delivered_in_the_window_to_the_last_one():
    deliveries = [Delivery(0, 0, 128, 10.5), Delivery(0, 128, 128, 11.0),
                  Delivery(1, 0, 64, 12.0), Delivery(1, 64, 128, 40.5)]
    # 320 frames in [10, 40]; the last of them at 12.0 s
    assert export_fps(deliveries, 10.0, 40.0) == pytest.approx(320 / 2.0)
    assert export_fps(deliveries, 10.0, 10.4) is None
    assert export_fps([Delivery(0, 0, 30, 9.0)], 10.0, 40.0) is None


def test_rate_ignores_deliveries_before_the_window():
    deliveries = [Delivery(0, 0, 100, 4.0), Delivery(0, 100, 50, 6.0)]
    assert export_fps(deliveries, 5.0, 30.0) == pytest.approx(50 / 1.0)


def test_sink_keeps_the_picked_frames_and_stops_the_scene_after_the_end():
    window = Window(start=0.0, end=float("inf"))
    scene = types.SimpleNamespace(quit=False)
    sink = BenchSink(window, job=3, keep={1, 5}, scene=scene)
    frames = np.arange(4 * 2 * 2 * 3, dtype=np.uint8).reshape(4, 2, 2, 3)
    sink.write_batch(frames)
    sink.write_batch(frames + 1)
    assert sorted(window.kept) == [(3, 1), (3, 5)]
    assert np.array_equal(window.kept[(3, 5)], frames[1] + 1)
    assert [(d.first, d.count) for d in window.deliveries] == [(0, 4), (4, 4)]
    assert scene.quit is False
    window.end = 0.0
    sink.write_batch(frames)
    assert scene.quit is True
