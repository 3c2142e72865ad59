"""The whole-step window and the reduction of a device trace."""
from __future__ import annotations

import time

import pytest

from h100_bench.bench import trace
from h100_bench.bench.compare import judge
from h100_bench.entries.train import Feed


class _Loader:
    batch_size = 2

    def __init__(self, n, wait=0.0):
        self.n, self.wait = n, wait

    def __iter__(self):
        for i in range(self.n):
            time.sleep(self.wait)
            yield {"i": i}


def _epoch(feed, step_s):
    """What the trainer's epoch loop does with its loader."""
    done = 0
    for _ in feed:
        time.sleep(step_s)
        done += 1
    return done


def test_the_set_up_pass_yields_its_steps_and_calls_its_hooks():
    seen = []
    feed = Feed(_Loader(20), trace.Spans(), lambda: None)
    feed.capture = 2
    feed.plan(steps=4, hooks={2: lambda: seen.append(2), 5: lambda: seen.append(5)})
    assert _epoch(feed, 0.0) == 4
    assert seen == [2, 5] and [b["i"] for b in feed.captured] == [0, 1]


def test_the_window_is_whole_steps_over_their_count():
    feed = Feed(_Loader(100), trace.Spans(), lambda: None)
    feed.plan(steps=2)
    _epoch(feed, 0.0)
    feed.plan(seconds=0.25)
    steps = _epoch(feed, 0.04)
    assert steps == len(feed.waits)
    span = feed.t_end - feed.t0
    # the last step began inside the window and ran to its end
    assert 0.25 <= span < 0.25 + 0.04 + 0.03
    assert steps == pytest.approx(span / 0.04, abs=1.0)
    # the second pass went on from the first: no epoch restarted
    assert feed._it is not None and not feed.ended_early


def test_the_window_ends_at_the_end_of_the_split():
    feed = Feed(_Loader(5), trace.Spans(), lambda: None)
    feed.plan(seconds=60)
    assert _epoch(feed, 0.0) == 5
    assert feed.ended_early and len(feed.waits) == 5


def test_the_loader_wait_is_recorded_as_a_span():
    spans = trace.Spans()
    feed = Feed(_Loader(3, wait=0.02), spans, lambda: None)
    feed.plan(seconds=60)
    _epoch(feed, 0.0)
    waits = spans.named("loader_wait")
    assert len(waits) == 3 and all(w >= 0.015 for w in waits)


def test_busy_time_is_the_union_of_every_stream():
    events = [("k1", 0, 100), ("copy", 50, 150), ("k2", 300, 400), ("k3", 390, 420),
              ("outside", 1000, 2000)]
    r = trace.reduce(events, 0, 500)
    assert r["busy_s"] == pytest.approx(270e-9)
    assert r["window_s"] == pytest.approx(500e-9)
    assert r["kernels"]["k1"] == (pytest.approx(100e-9), 1)
    assert [g[1] for g in r["idle_gaps"]] == pytest.approx([150e-9, 80e-9])


def test_an_event_across_the_window_is_clipped():
    r = trace.reduce([("k", -50, 50), ("k", 90, 200)], 0, 100)
    assert r["busy_s"] == pytest.approx(60e-9)
    assert r["kernels"]["k"] == (pytest.approx(60e-9), 2)


def test_idle_gaps_are_named_by_the_main_threads_span():
    spans = trace.Spans(anchor=(0, 0))
    spans.items.append(("dispatch", 0.0, 100e-9, "MainThread"))
    spans.items.append(("write", 0.0, 1.0, "evsr-write_0"))
    spans.items.append(("fetch", 150e-9, 300e-9, "MainThread"))
    r = trace.reduce([("k", 0, 20), ("k", 60, 160), ("k", 290, 300)], 0, 300, spans)
    assert [g[0] for g in r["idle_gaps"]] == ["fetch", "dispatch"]


def test_a_kernel_name_matches_as_a_word():
    r = {"kernels": {"void lstm_gates_kernel<float, 4>(float*)": (1.0, 3),
                     "void lstm_gates_bwd_kernel<float, 4>(float*)": (2.0, 1),
                     "deform_col2im_coord_kernel<float>": (4.0, 5),
                     "deform_col2im_kernel<float>": (8.0, 7)}}
    assert trace.kernel_time(r, "lstm_gates_kernel") == (1.0, 3)
    assert trace.kernel_time(r, "deform_col2im_kernel") == (8.0, 7)


def test_judge_fails_a_number_over_its_limit_or_missing():
    assert judge({"a": 1.0, "b": 0.0}, {"a": 1.0, "b": 0.0})[0]
    assert not judge({"a": 1.5}, {"a": 1.0})[0]
    assert not judge({}, {"a": 1.0})[0]
    assert not judge({"a": float("nan")}, {"a": 1.0})[0]
