"""The idle and span arithmetic of :mod:`benchmark.trace` and the readers of
:mod:`benchmark.metrics` on synthetic Chrome traces."""

import pytest

from benchmark import run, trace

MAIN, AUTOGRAD = 11, 12


def annotation(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": "bench:" + name, "ts": ts, "dur": dur,
            "tid": tid}


def launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def kernel(corr, ts, dur, name="k", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def synthetic():
    """A window of 1200 us with two steps: each an encoder (a 100 us kernel), a backbone (two
    kernels of 150 us) and a decoder (50 us); a 20 us copy outside the parts; then a 30 us
    kernel from another thread, and one of 50 us that runs past the window's end."""
    ev = [annotation("window", 0, 1200)]
    corr = 0
    for s, base in enumerate((0, 500)):
        ev.append(annotation("step", base, 495))
        for part, start, kernels in (("encoder", base + 10, [100]),
                                     ("backbone", base + 120, [150, 150]),
                                     ("decoder", base + 435, [50])):
            ev.append(annotation(part, start, sum(d + 5 for d in kernels)))
            t = start
            for d in kernels:
                corr += 1
                ev += [launch(corr, t + 1), kernel(corr, t + 5, d)]
                t += d + 5
        corr += 1
        ev += [launch(corr, base + 492), kernel(corr, base + 493, 20, "Memcpy DtoH", "gpu_memcpy")]
    ev += [launch(101, 1100, AUTOGRAD), kernel(101, 1105, 30, "bw"),
           launch(102, 1140), kernel(102, 1180, 50, "late")]
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 460, "dur": 40,
               "tid": MAIN})
    return ev


def test_union_and_gaps():
    assert trace.union([(0, 10), (5, 20), (30, 40)], 0, 35) == 25
    assert trace.gaps([(0, 10), (5, 20), (30, 40)], 0, 50) == [(20, 30), (40, 50)]


def test_a_synthetic_trace_reads_as_built():
    r = trace.read(synthetic(), ("encoder", "backbone", "decoder"))
    us = 1e-6
    assert r.steps == 2 and r.window_s == pytest.approx(1200 * us)
    assert r.span_s["encoder"] == pytest.approx(200 * us)
    assert r.span_s["backbone"] == pytest.approx(600 * us)
    assert r.span_s["decoder"] == pytest.approx(100 * us)
    assert r.outside_s == pytest.approx((40 + 50) * us)
    assert r.other_thread_s == pytest.approx(30 * us)
    busy = 2 * (100 + 150 + 150 + 50 + 20) + 30 + 20  # the last kernel clipped at the end
    assert r.busy_s == pytest.approx(busy * us)
    assert r.idle_share == pytest.approx(1 - busy / 1200)
    assert r.device_ops[0] == ["k", pytest.approx(900 * us)]
    assert len(r.idle_gaps) <= 10 and all(s > 0 for _, s in r.idle_gaps)


def test_the_readers_on_the_synthetic_trace():
    r = trace.read(synthetic(), ("encoder", "backbone", "decoder"))
    r.counts = dict(forward={"encoder": 1e6, "backbone": 3e6, "decoder": 1e6}, backward=5e6,
                    backbone_bytes=0, peak_flops=1e12, hbm=1e12)
    got = {m: run.reader(m)(r) for m in ("encoder_ms.forecast", "decoder_ms.forecast",
                                         "rollout_other_ms.forecast", "backward_ms.train",
                                         "mfu.forecast", "mfu.train",
                                         "backbone_roofline.forecast", "device_idle.forecast")}
    assert got["encoder_ms.forecast"] == pytest.approx(0.1)
    assert got["decoder_ms.forecast"] == pytest.approx(0.05)
    assert got["rollout_other_ms.forecast"] == pytest.approx(0.045)
    assert got["backward_ms.train"] == pytest.approx(0.015)
    assert got["mfu.forecast"] == pytest.approx(100 * 2 * 5e6 / (1.2e-3 * 1e12))
    assert got["mfu.train"] == pytest.approx(100 * 2 * 10e6 / (1.2e-3 * 1e12))
    assert got["backbone_roofline.forecast"] == pytest.approx(100 * 3e-6 / 300e-6)
    assert got["device_idle.forecast"] == pytest.approx(100 * r.idle_share)


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError, match="no device operation"):
        trace.read([annotation("window", 0, 100)], ("encoder",))


def test_a_part_with_no_time_reads_nothing():
    r = trace.read(synthetic(), ("encoder", "backbone", "decoder"))
    r.span_s["backbone"] = 0.0
    r.counts = dict(forward={"backbone": 1.0}, backbone_bytes=0, peak_flops=1.0, hbm=1.0)
    assert run.reader("backbone_roofline.forecast")(r) is None
