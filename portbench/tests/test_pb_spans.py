"""The port's spans joined to a device trace (``portbench/spans.py``):
regions by span name on synthetic trace events, idle gaps named by the
spans with every other key of the summary unchanged, the flight
recorder's rows of an armed stretch, and the three readers on synthetic
records."""

import threading

import pytest
import torch

from portbench import spans
from portbench.trace import summarize

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
# a thread whose pthread id has bits above 32 and the 32nd set: CUPTI
# reports it as the signed low word
THREAD_A = 0x7F00_8000_0001
CUPTI_A = -(2 ** 31) + 1
THREAD_B = 7


class _Ev:
    def __init__(self, name, start, end, dev=CPU, corr=0, res=0):
        self._v = (name, start, end, dev, corr, res)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]


def _span(name, start, end, thread):
    return {"name": name, "start": start, "end": end, "thread": thread}


EVENTS = [
    _Ev("cudaLaunchKernel", 210, 215, corr=1, res=CUPTI_A), _Ev("k1", 220, 400, CUDA, corr=1),
    _Ev("cudaLaunchKernel", 260, 265, corr=2, res=THREAD_B), _Ev("k2", 400, 500, CUDA, corr=2),
    _Ev("cudaLaunchKernel", 500, 505, corr=3, res=CUPTI_A), _Ev("k3", 500, 700, CUDA, corr=3),
    _Ev("cudaLaunchKernel", 1050, 1055, corr=4, res=CUPTI_A), _Ev("k4", 1080, 1200, CUDA, corr=4),
    _Ev("Activity Buffer Request", 300, 310),
]
SPANS = [
    _span("outer", 150, 600, THREAD_A), _span("inner", 200, 300, THREAD_A),  # nested
    _span("other", 250, 450, THREAD_B),  # k1 ran inside it, launched from A
    _span("wait", 650, 1000, THREAD_B),  # around the one idle gap
    _span("edge", 1000, 1300, THREAD_A),  # cut by the stretch's end
    _span("before", 0, 90, THREAD_A),  # outside the stretch
]


def test_regions_by_span_name_over_the_stretch():
    reg = spans.regions(EVENTS, 100, 1100, SPANS)
    ns = lambda r: {k: (v if k == "count" else round(v * 1e9)) for k, v in r.items()}
    assert set(reg) == {"outer", "inner", "other", "wait", "edge"}
    assert ns(reg["inner"]) == {"count": 1, "host_s": 100, "device_s": 180, "extent_s": 100}
    assert ns(reg["outer"]) == {"count": 1, "host_s": 450, "device_s": 180 + 200, "extent_s": 450}
    assert ns(reg["other"]) == {"count": 1, "host_s": 200, "device_s": 100, "extent_s": 200}
    assert ns(reg["wait"]) == {"count": 1, "host_s": 350, "device_s": 0, "extent_s": 350}
    assert ns(reg["edge"]) == {"count": 1, "host_s": 100, "device_s": 20, "extent_s": 100}


def test_two_spans_of_a_name_count_their_union_and_their_extent():
    two = [_span("batch", 150, 250, THREAD_A), _span("batch", 450, 600, THREAD_A)]
    reg = spans.regions(EVENTS, 100, 1100, two)["batch"]
    assert reg["count"] == 2
    assert reg["host_s"] == pytest.approx(250 / 1e9)
    assert reg["extent_s"] == pytest.approx(450 / 1e9)
    assert reg["device_s"] == pytest.approx(380 / 1e9)  # k1 from the first, k3 from the second


def test_the_spans_name_idle_gaps_and_leave_every_other_key_as_it_was():
    plain = summarize(EVENTS, 100, 1100)
    joined = spans.join(EVENTS, 100, 1100, SPANS)
    assert set(joined) == set(plain) | {"regions"}
    for key in plain:
        if key != "idle_gaps":
            assert joined[key] == plain[key], key
    assert dict(plain["idle_gaps"]) == {"no host operation recorded": pytest.approx(380 / 1e9)}
    assert dict(joined["idle_gaps"]) == {"wait": pytest.approx(380 / 1e9)}


def test_an_armed_stretch_reads_back_the_spans_of_every_thread():
    from ray_tpu_torch.util import tracing

    since = spans.arm()
    try:
        def work():
            with tracing.span("predict.batch"):
                with tracing.span("predict.apply"):
                    pass

        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    finally:
        spans.disarm()
    with tracing.span("after"):
        pass
    got, lost = spans.recorded(since)
    assert lost == 0 and [s["name"] for s in got] == ["predict.apply", "predict.batch"]
    assert got[0]["thread"] == got[1]["thread"] == th.ident != threading.get_ident()
    assert got[1]["start"] <= got[0]["start"] <= got[0]["end"] <= got[1]["end"]


def _ctx(**regions):
    return {"trace": {"busy_s": 2.0, "window_s": 2.05, "regions": regions, "span_rows": 9,
                      "span_rows_lost": 0}}


def test_the_readers_on_synthetic_records():
    region = lambda count, host, dev, extent: {"count": count, "host_s": host,
                                               "device_s": dev, "extent_s": extent}
    ctx = _ctx(**{"engine.prefill": region(3, 0.2, 0.05, 1.5)})
    assert spans.prefill_share_decode(ctx) == pytest.approx(2.5)
    assert spans.prefill_share_decode(_ctx()) == 0.0  # no prefill in the stretch
    assert spans.prefill_share_decode({"trace": {"busy_s": 2.0}}) is None  # no spans

    # 256 rows at 379 positions a step; a layer's K and V of 12 heads x 64
    # in bf16: 379 * 256 * 3072 bytes at 3.35 TB/s, against 2.2 ms a span
    stats = lambda steps, pos: {"stats": {"decode_steps": steps, "kv_positions_attended": pos}}
    dec = _ctx(**{"gen.decode_attend": region(1200, 1.0, 1200 * 2.2e-3, 2.0)})
    dec.update(kind="NVIDIA H100 80GB HBM3", dims={"d_model": 768, "n_heads": 12},
               untraced={"counters": {"open": stats(1000, 7), "close": stats(1100, 7 + 100 * 379 * 256)}})
    least = 379 * 256 * 3072 / 3.35e12
    assert spans.decode_attend_roofline_decode(dec) == pytest.approx(100 * least / 2.2e-3)
    assert 3 < spans.decode_attend_roofline_decode(dec) < 6
    parent = dict(dec, untraced={"counters": {"open": {"stats": {}}, "close": {"stats": {}}}})
    assert spans.decode_attend_roofline_decode(parent) is None  # an engine without the counters

    score = _ctx(**{"predict.batch": region(19, 0.9, 0.8, 1.0)})
    assert spans.batch_wait_share_score(score) == pytest.approx(10.0)
    lost = _ctx(**{"predict.batch": region(19, 0.9, 0.8, 1.0)})
    lost["trace"]["span_rows_lost"] = 4
    assert spans.batch_wait_share_score(lost) is None
