"""The counting functions of the roofline metrics and the trace reader, on
small shapes."""

import json

import pytest
import torch

from portbench.harness import counting, trace as tracing
from portbench.reference import mandelbrot


def test_elementwise_ops_are_counted_per_output_element():
    x = torch.rand(4, 8)
    _, ops = counting.count_elementwise(lambda a: torch.exp(a * 2.0 + 1.0), x)
    assert ops == 3 * 32
    _, ops = counting.count_elementwise(lambda a: a.reshape(8, 4).clone().to(torch.float64), x)
    assert ops == 0


def test_a_select_counts_only_the_branch_it_takes():
    x = torch.rand(4, 8)
    taken = int((x > 0.5).sum())
    # compare and select everywhere; exp and its product where taken, the sum elsewhere
    _, ops = counting.count_elementwise(
        lambda a: torch.where(a > 0.5, torch.exp(a) * 2.0, a + 1.0), x)
    assert ops == 2 * 32 + 2 * taken + (32 - taken)
    _, ops = counting.count_elementwise(lambda a: torch.where(a > 2.0, torch.exp(a), a), x)
    assert ops == 2 * 32


def test_a_shared_op_counts_once_and_an_unread_one_not():
    x = torch.rand(4, 8)
    _, ops = counting.count_elementwise(
        lambda a: (lambda y: torch.where(a > 0.5, y + 1.0, y - 1.0))(a * 2.0), x)
    assert ops == 4 * 32
    # of the 32 products only the 8 that the slice keeps are read, then one sum
    _, ops = counting.count_elementwise(lambda a: (a[:, None, :] * 2.0)[:, 0, :2].sum(), x)
    assert ops == 8 + 1
    _, ops = counting.count_elementwise(lambda a: [torch.exp(a), torch.exp(a)[0]][1], x)
    assert ops == 8


def test_least_time_takes_the_larger_bound():
    seconds, by = counting.least_seconds(counting.F32_FLOPS_PER_S, 0)
    assert (seconds, by) == (pytest.approx(1.0), "operations")
    seconds, by = counting.least_seconds(0, 2 * counting.HBM_BYTES_PER_S)
    assert (seconds, by) == (pytest.approx(2.0), "bytes")
    assert counting.share_pct(1.0, 4.0) == pytest.approx(25.0)
    assert counting.share_pct(1.0, 0.0) is None


def test_useful_escape_steps_match_a_pixel_by_pixel_count():
    cx, cy, _ = mandelbrot.c_lines(24, 16, 1.5, "cpu")
    counts, useful = mandelbrot.escape_counts(cx, cy, 500, 142, rows=5)
    expected = 0
    for i in range(16):
        for j in range(24):
            c = complex(float(cx[j]), float(cy[i]))
            xq = c.real - 0.25
            q = xq * xq + c.imag * c.imag
            if q * (q + xq) <= 0.25 * c.imag ** 2 or (c.real + 1) ** 2 + c.imag ** 2 <= 0.0625:
                assert counts[i, j] == 500
                continue
            z, n = c, 0
            while abs(z) ** 2 <= 9.0 and n < 142:
                z, n = z * z + c, n + 1
            assert abs(counts[i, j] - n) <= 1      # float64 here, float32 there
            expected += int(counts[i, j])
    assert useful == expected


def test_union_of_device_intervals():
    assert tracing.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_chrome_trace_events_take_the_innermost_span_of_their_launch(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.engine.flush", "tid": 1, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "pb.fragment", "tid": 1, "ts": 10, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "pb.tail", "tid": 1, "ts": 40, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 15, "dur": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "tid": 1, "ts": 45, "dur": 1,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "tid": 1, "ts": 70, "dur": 1,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "escape_kernel", "tid": 9, "ts": 20, "dur": 5,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "tail_kernel", "tid": 9, "ts": 50, "dur": 10,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "tid": 9,
         "ts": 80, "dur": 30, "args": {"correlation": 9, "bytes": 600}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    device, extent = tracing.read_chrome_trace(path)
    spans = {event.name: event.span for event in device}
    assert spans == {"escape_kernel": "fragment", "tail_kernel": "tail",
                     "Memcpy DtoH (Device -> Pinned)": "engine.flush"}
    assert extent == (0.0, 110.0)
    trace = tracing.Trace(device=device, stretch=extent, frame_bytes=300)
    assert trace.device_seconds(span="tail") == pytest.approx(10e-6)
    assert trace.busy_seconds() == pytest.approx(45e-6)
    from portbench.harness.registry import metric_reader
    assert metric_reader("device.idle_pct")(trace) == pytest.approx(100 * (1 - 45 / 110))
    assert metric_reader("wire.d2h_ms")(trace) == pytest.approx(1e3 * 30e-6 / 2)
