"""The three host-time readers over synthetic span lists: which steps they
take, and their medians."""

import pytest

from hdbench import run
from hierdiff_torch.utils import profiling

READERS = ("host_step_ms.sample", "host_wrappers_ms.sample", "host_plain_ms.sample")
MS = 1_000_000   # ns


class Spans:
    """A span list in ``profiling.spans()``'s form, built by hand."""

    def __init__(self):
        self.records = []

    def add(self, name, start_ms, end_ms, parent=None, request=1, **attrs):
        index = len(self.records)
        self.records.append({"name": name, "start_ns": int(start_ms * MS),
                             "end_ns": None if end_ms is None else int(end_ms * MS),
                             "index": index, "parent": parent, "request": request,
                             "attrs": attrs})
        return index

    def step(self, k, start_ms, wall_ms, wrappers_ms=(), request=1):
        """A step of ``wall_ms`` with wrapper spans of the given lengths."""
        i = self.add("coarse.step", start_ms, start_ms + wall_ms, request=request, k=k)
        at = start_ms
        for j, w in enumerate(wrappers_ms):
            name = "egnn.fused_gcl" if j % 2 == 0 else "egnn.fused_coord_update"
            self.add(name, at, at + w, parent=i, request=request, B=1, N=2, H=3)
            at += w
        return i


def _read(monkeypatch, records, steps):
    monkeypatch.setattr(profiling, "spans", lambda: records)
    ctx = {"trace": {"steps": steps}}
    return [run.load_reader(name)(ctx) for name in READERS]


def test_known_medians(monkeypatch):
    s = Spans()
    s.step(1, 0.0, 4.0, (0.5, 0.25))
    s.step(2, 10.0, 6.0, (1.0, 0.5))
    s.step(3, 20.0, 5.0, (0.25,))
    step, wrappers, plain = _read(monkeypatch, s.records, 3)
    assert step == pytest.approx(5.0)
    assert wrappers == pytest.approx(0.75)
    assert plain == pytest.approx(6.0 - 1.5)   # the middle of 3.25, 4.5, 4.75


def test_the_first_steps_by_k_of_the_newest_request(monkeypatch):
    s = Spans()
    for k in range(1, 4):     # an older request: long steps
        s.step(k, 10.0 * k, 100.0, (50.0,), request=7)
    # the newest request, its steps out of order, one still open
    s.step(5, 600.0, 9.0, (1.0,), request=8)
    s.step(3, 400.0, 2.0, (1.0,), request=8)
    s.step(4, 500.0, 3.0, (1.0,), request=8)
    s.add("coarse.step", 700.0, None, request=8, k=6)
    s.step(2, 300.0, 4.0, (1.0,), request=8)
    step, wrappers, plain = _read(monkeypatch, s.records, 2)
    assert step == pytest.approx(3.0)     # steps 2 and 3 of request 8
    assert wrappers == pytest.approx(1.0)
    assert plain == pytest.approx(2.0)
    assert _read(monkeypatch, s.records, 0)[0] == pytest.approx(3.5)   # all four closed


def test_a_step_without_wrapper_spans_reads_zero(monkeypatch):
    s = Spans()
    req = s.add("coarse.request", 0.0, 100.0)
    for k in range(1, 4):
        i = s.step(k, 10.0 * k, 2.0)
        s.records[i]["parent"] = req
    s.add("egnn.fused_gcl", 90.0, 91.0, parent=req)   # the final draw's: no step's
    step, wrappers, plain = _read(monkeypatch, s.records, 3)
    assert (step, wrappers, plain) == (pytest.approx(2.0), 0.0, pytest.approx(2.0))


def test_nothing_to_read(monkeypatch):
    s = Spans()
    s.add("coarse.request", 0.0, 1.0)
    s.add("egnn.fused_gcl", 0.0, 1.0, parent=0)
    assert _read(monkeypatch, s.records, 3) == [None, None, None]
    assert _read(monkeypatch, [], 3) == [None, None, None]
    monkeypatch.delattr(profiling, "spans")   # a program that keeps no spans
    ctx = {"trace": {"steps": 3}}
    assert [run.load_reader(name)(ctx) for name in READERS] == [None, None, None]
