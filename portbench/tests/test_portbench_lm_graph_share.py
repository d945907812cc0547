"""`lm_graph_share` on made-up span records: window BA's `lm_attempt` spans
with `graph` 1 over all of them, inside the traced frames.  Attempts outside
window BA (the plain pose solve's) and spans outside the traced frames' host
window are left out; a program whose attempts carry no `graph` attribute, or
that keeps no record at all, gives nothing."""

import types

import pytest

from legoslam_tpu_torch.utils import timer
from portbench.harness import reader

T0 = 5_000_000_000  # ns, the traced frames' start on the host clock


def _record(graphs):
    spans = [timer.Span("ba", 0, -1, 1, 0, {}, T0 + 10, T0 + 800, 0),
             timer.Span("lm_solve", 1, 0, 1, 0, {}, T0 + 20, T0 + 700, 0)]
    spans += [timer.Span("lm_attempt", 2 + k, 1, 1, 0, {"attempt": k} if g is None else {"attempt": k, "graph": g},
                         T0 + 30 + 10 * k, T0 + 35 + 10 * k, 0) for k, g in enumerate(graphs)]
    # Left out: the plain pose solve's attempt, and an attempt after the traced frames.
    spans.append(timer.Span("pose", 50, -1, 1, 0, {}, T0 + 850, T0 + 900, 0))
    spans.append(timer.Span("lm_attempt", 51, 50, 1, 0, {"attempt": 0, "graph": 0}, T0 + 860, T0 + 870, 0))
    spans.append(timer.Span("lm_attempt", 99, 1, 1, 0, {"attempt": 0, "graph": 0}, T0 + 2000, T0 + 2010, 0))
    return spans


def _context():
    return types.SimpleNamespace(frames=[{"start": 1e-9 * T0, "done": 1e-9 * (T0 + 1000)}])


@pytest.mark.parametrize("graphs, share", [((1, 1), 1.0), ((1, 0, 0, 0), 0.25), ((0, 0), 0.0),
                                           ((None, None), None)])
def test_lm_graph_share_counts_replayed_attempts(monkeypatch, graphs, share):
    monkeypatch.setattr(timer, "records", lambda: _record(graphs))
    assert reader("lm_graph_share")(_context()) == share


def test_lm_graph_share_without_a_record(monkeypatch):
    monkeypatch.setattr(timer, "records", lambda: [])
    assert reader("lm_graph_share")(_context()) is None
    monkeypatch.delattr(timer, "records")  # a program from before the record
    assert reader("lm_graph_share")(_context()) is None
