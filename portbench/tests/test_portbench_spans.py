"""The spans' passes (``spans.py``) on synthetic profiles: device time
charged to module spans, backward work to its forward op's span, the
spans' device-side annotations left out, idle gaps put down to the host's
phase; and the readers through a traced run on the CPU."""

import pytest
from conftest import TINY

from item_alignment_torch.engine import observability
from item_alignment_torch.engine.observability import Span
from portbench import run, spans
from portbench.spans import Device, Host

MAIN, AUTOGRAD = 1, 2


def annotation(name, start, end, thread=MAIN):
    return Host(start, end, thread, "ia." + name, 0, -1, 0)


def op(name, start, end, seq=-1, thread=MAIN, fwd_thread=0):
    return Host(start, end, thread, name, 0, seq, fwd_thread)


def launch(at, corr, thread=MAIN):
    """The runtime's call that launched device operation ``corr``."""
    return Host(at, at + 1, thread, "cudaLaunchKernel", corr, -1, 0)


def test_rest_is_partitioned_among_the_spans_and_unspanned():
    host = [annotation("forward", 0, 100),
            annotation("embeddings", 1, 30),
            annotation("layernorm", 10, 20),      # inside embeddings
            op("aten::mul", 11, 13), launch(12, 1),
            op("aten::index", 2, 4), launch(3, 2),
            annotation("cast", 40, 45),
            op("aten::_to_copy", 41, 44), launch(42, 3),
            op("aten::addmm", 46, 48), launch(47, 4),  # the product
            op("aten::add", 50, 52), launch(51, 5),    # the residual
            annotation("optim", 60, 90),
            op("aten::_foreach_mul_", 61, 63), launch(62, 6)]
    device = [Device(100, 110, "elementwise_kernel_mul", 1),
              Device(110, 113, "indexSelectLargeIndex", 2),
              Device(113, 117, "unrolled_elementwise_kernel_copy", 3),
              Device(117, 150, "nvjet_tst_256x128", 4),
              Device(150, 155, "vectorized_elementwise_kernel_add", 5),
              Device(155, 165, "multi_tensor_apply_kernel", 6),
              Device(165, 166, "Memcpy HtoD (Pinned -> Device)", 99)]
    modules = spans.MODULES + ("embeddings",)  # a family's span
    assert spans.charge(host, device, modules) == [
        "layernorm", "embeddings", "cast", None, None, "optim", None]
    ns = spans.attribute(host, device, modules)
    assert ns["rest"] == {"layernorm": 10, "embeddings": 3, "cast": 4,
                          "unspanned": 5, "optim": 10}
    assert ns["all"] == ns["rest"]  # the product and the copy: no span
    rest = sum(d.end - d.start for d in device
               if spans.group_of(d.name) == "rest")
    assert sum(ns["rest"].values()) == rest


def test_backward_work_goes_to_its_forward_ops_span():
    host = [annotation("forward", 0, 100),
            # an op outside the span takes the sequence number first; the
            # op that makes the node, inside the dropout span, takes it last
            op("aten::empty", 5, 6, seq=7),
            annotation("dropout", 10, 20),
            op("_ReplayDropout", 11, 19, seq=7),
            op("aten::add", 30, 31, seq=8),  # a residual add
            annotation("backward", 200, 400),
            # the autograd engine's thread runs the nodes
            op("autograd::engine::evaluate_function: _ReplayDropoutBackward",
               210, 240, seq=7, thread=AUTOGRAD, fwd_thread=MAIN),
            op("_ReplayDropoutBackward", 211, 239, seq=7, thread=AUTOGRAD,
               fwd_thread=MAIN),
            op("aten::randint", 212, 215, thread=AUTOGRAD),
            launch(213, 12, AUTOGRAD),
            launch(221, 13, AUTOGRAD),  # a kernel launched through ctypes
            op("AddBackward0", 250, 260, seq=8, thread=AUTOGRAD,
               fwd_thread=MAIN),
            op("aten::copy_", 251, 253, thread=AUTOGRAD),
            launch(252, 15, AUTOGRAD),
            # accumulated into a leaf: no forward op
            op("torch::autograd::AccumulateGrad", 270, 280, thread=AUTOGRAD),
            op("aten::add_", 271, 273, thread=AUTOGRAD),
            launch(272, 17, AUTOGRAD)]
    device = [Device(300, 301, "distribution_elementwise_grid_stride", 12),
              Device(301, 305, "elementwise_kernel_where", 13),
              Device(305, 306, "unrolled_elementwise_kernel_copy", 15),
              Device(306, 307, "vectorized_elementwise_kernel_add", 17),
              Device(307, 308, "elementwise_kernel", 404)]  # no launch
    assert spans.charge(host, device) == ["dropout", "dropout", None, None,
                                          None]
    assert spans.attribute(host, device)["rest"] == {"dropout": 5,
                                                     "unspanned": 3}


class Event:
    """A profiler event as ``_KinetoEvent`` shows it."""

    def __init__(self, name, device, start, duration, corr=0, seq=-1,
                 thread=MAIN, fwd_thread=0):
        self._v = dict(name=name, device_type=device,
                       start_ns=start, duration_ns=duration,
                       correlation_id=corr, sequence_nr=seq,
                       start_thread_id=thread, fwd_thread_id=fwd_thread)

    def __getattr__(self, key):
        return lambda: self._v[key]


def test_device_operations_link_their_launch_not_the_annotations():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    # as the profiler gives them: an operator and a runtime's call may
    # carry the same id, and each range has a device-side annotation
    host, device = spans.split([
        Event("ia.layernorm", cpu, 10, 20, corr=1),
        Event("aten::mul", cpu, 12, 4, corr=7, seq=3),
        Event("cudaLaunchKernel", cpu, 14, 1, corr=8),
        Event("ia.layernorm", cuda, 40, 30, corr=1),
        Event("elementwise_kernel", cuda, 45, 5, corr=8),
        Event("ia.attention", cpu, 50, 20, corr=3),
        Event("aten::add", cpu, 51, 2, corr=8, seq=4),
        Event("cudaLaunchKernel", cpu, 60, 1, corr=7),  # through ctypes
        Event("attn_fwd_bf16", cuda, 62, 9, corr=7)])
    assert len(host) == 6
    assert host[1] == Host(12, 16, MAIN, "aten::mul", 7, 3, 0)
    assert device == [Device(45, 50, "elementwise_kernel", 8),
                      Device(62, 71, "attn_fwd_bf16", 7)]
    assert spans.charge(host, device) == ["layernorm", "attention"]


def test_gaps_go_to_the_phase_open_on_the_host():
    def span(name, start, end, parent=None):
        return Span(name, parent, start, end, 0)

    t0 = 1_000_000
    step = span("step", t0 + 5_000, t0 + 100_000)
    recorded = [span("stage", t0 + 0, t0 + 5_000),
                step,  # a child's clock is read after its parent's
                span("forward", t0 + 5_100, t0 + 40_000, step),
                span("layernorm", t0 + 10_000, t0 + 30_000),  # a module
                span("backward", t0 + 40_000, t0 + 80_000, step),
                span("optim", t0 + 80_000, t0 + 100_000, step),
                span("build_cache", t0 + 100_000, t0 + 130_000),
                span("encode", t0 + 110_000, t0 + 120_000)]
    device = [Device(t0 + a, t0 + b, "k", 0) for a, b in
              [(2_000, 12_000),      # gap 0-2 us: stage
               (22_000, 50_000),     # gap 12-22 us: forward (in layernorm)
               (60_000, 85_000),     # gap 50-60 us: backward
               (89_000, 101_000),    # gap 85-89 us: optim
               (104_000, 111_000),   # gap 101-104 us: build_cache
               (113_000, 118_000),   # gap 111-113 us: encode
               (122_000, 135_000)]]  # gap 118-122 us: encode (middle 120)
    # gap 135-140 us: no span
    trace = spans.phase_trace(recorded, device, t0, t0 + 140_000)
    idle = spans.idle_by_phase(trace)
    assert idle == pytest.approx({"stage": 2e-6, "forward": 10e-6,
                                  "backward": 10e-6, "optim": 4e-6,
                                  "build_cache": 3e-6, "encode": 6e-6,
                                  "no host range": 5e-6})
    assert sum(idle.values()) == pytest.approx(
        trace.window_s - trace.busy_s)


def test_no_readings_without_spans_or_job(monkeypatch):
    assert spans.of({}) is None  # no traced() stored any
    assert spans.of({"spans": None}) is None

    class Job:
        def unit(self, n):
            pytest.fail("ran")

    monkeypatch.delattr(observability, "tracing")
    assert spans.passes(Job(), {}) is None  # a program without spans


def test_a_traced_cpu_run_reads_the_host_spans(tiny):
    line = run.run_cell(tiny("large-train-s510"), 2 ** 31 + 7, 0.2, True,
                        "cpu", TINY)
    got = line["metrics"]
    assert {"stage_ms.train", "dispatch_ms.train"} <= set(got)
    assert 0 < got["stage_ms.train"]["value"] < got["dispatch_ms.train"][
        "value"]
    # no device ran: the device's metrics are left out
    assert not any(k.startswith(("module_ms", "idle_ms")) for k in got)
    assert line["correct"], line["checks"]
