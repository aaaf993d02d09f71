"""The end-to-end readers on a run's records: the rate counts every
request sent in the window, those answered after its close included, over
the time to the last answer; the latencies take every request."""

from types import SimpleNamespace

import pytest

from benchmark import harness


def _run(done_times):
    records = [{"ok": True, "images": [b"png"], "t_send": 0.0,
                "t_done": t} for t in done_times]
    run = SimpleNamespace(records=records, t0=0.0, t_end=10.0)
    run.latencies = lambda: harness.Run.latencies(run)
    return run


def test_rate_counts_requests_in_flight_at_the_close():
    run = _run([4.0, 4.0, 8.0, 8.0, 12.0, 12.0])
    assert harness.reader("images_per_s")(run) == pytest.approx(6 / 12.0)


def test_rate_sees_a_stall_in_the_window_tail():
    """Answers at 8 s, then a stall to 14 s: the rate takes the stall."""
    quick = harness.reader("images_per_s")(_run([4.0, 8.0, 11.0]))
    stalled = harness.reader("images_per_s")(_run([4.0, 8.0, 14.0]))
    assert stalled < quick


def test_latencies_take_every_request():
    run = _run([1.0, 2.0, 3.0, 4.0, 30.0])
    assert harness.reader("latency_p50_s")(run) == 3.0
    assert harness.reader("latency_p95_s")(run) > 4.0


def test_solo_metrics_are_their_quantities_readers():
    """A ``<metric>.solo`` (the one-client cells' split, under bounds of
    their own) reads with ``<metric>.py`` itself."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    twins = [m["name"] for m in manifest["end_to_end"] +
             manifest["per_layer"] if m["name"].endswith(".solo")]
    assert twins
    for name in twins:
        base = name[:-len(".solo")]
        assert harness.reader(name).__code__.co_filename == str(
            root / "benchmark" / "metrics" / f"{base}.py")
