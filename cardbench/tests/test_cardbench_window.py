"""The window cutter, the recorder's sample, the seam's reading of the
positions and the percentile arithmetic, on a fake clock."""
import statistics

import pytest

from cardbench import harness


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def drive(window, clock, steps, before=0):
    """``before`` value+grads of the entry's warm-up, then value+grads
    ``steps`` seconds apart until the window closes; returns the calls made."""
    calls = 0
    for _ in range(before):
        assert window.enter(16) is None
        calls += 1
    for dt in steps:
        try:
            index = window.enter(16)
        except harness.WindowClosed:
            return calls
        assert index == window.count - 1
        clock.t += dt
        window.leave(index)
        calls += 1
    raise AssertionError("the window never closed")


def test_window_opens_after_the_warm_up_calls_and_closes_after_its_seconds():
    clock = Clock()
    syncs = []
    w = harness.Window(1.0, calls_before=3, clock=clock, sync=lambda: syncs.append(clock.t))
    steps = [0.1] * 9 + [0.35] + [0.1] * 20
    drive(w, clock, steps, before=3)
    assert w.open_t == 100.0 and w.count == 10
    assert w.close_t == pytest.approx(101.25)
    assert syncs == [100.0, pytest.approx(101.25)]  # synchronised at both ends
    assert sum(w.intervals()) == pytest.approx(w.close_t - w.open_t)
    assert w.leapfrog_ms() == pytest.approx(125.0)
    assert w.leapfrog_ms_p95() == pytest.approx(1e3 * harness.percentile(w.intervals(), 95.0))


def test_percentile_matches_statistics_inclusive_quantiles():
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0, 3.5, 8.0, 7.0, 0.5]
    cuts = statistics.quantiles(xs, n=20, method="inclusive")
    assert harness.percentile(xs, 95.0) == pytest.approx(cuts[18])
    assert harness.percentile(xs, 50.0) == pytest.approx(statistics.median(xs))
    assert harness.percentile([2.0], 95.0) == 2.0


def test_quartile_spread_is_the_interquartile_range_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert harness.quartile_spread(xs) == pytest.approx((q3 - q1) / q2)


def test_the_stretch_is_left_out_of_the_intervals_outside_it():
    clock = Clock()
    events = []
    w = harness.Window(2.0, clock=clock, span_sync=True, stretch_at=0.5, stretch_n=4,
                       start_trace=lambda: events.append("start"), stop_trace=lambda: events.append("stop"))
    drive(w, clock, [0.125] * 40)
    assert events == ["start", "stop"]
    assert w.stretch_first == 8 and w.stretch_stop == 12
    out = w.outside_stretch()
    assert 7 not in out and 11 not in out and 6 in out and 12 in out
    assert len(out) == w.count - 5
    # the stretch's wall time does not count towards the window's seconds
    assert w.paused == pytest.approx(0.5) and w.close_t - w.open_t == pytest.approx(2.5)


def test_the_recorder_samples_from_the_seed_and_keeps_the_last():
    def kept(seed):
        r = harness.Recorder(4, seed)
        for i in range(100):
            r.offer(harness.Record(i, i, {}))
        assert r.thetas == list(range(100))
        return [rec.index for rec in r.items()]

    assert kept(7) == kept(7)
    assert kept(7) != kept(8)
    assert kept(7)[-1] == 99 and len(kept(7)) in (4, 5)


def test_the_seam_reads_the_positions_and_the_gradient_by_the_sites():
    """The wrapper finds the value+grad's positions behind the sites, and
    keeps d ll / d site whatever sign the potential gives the log-likelihood."""
    import torch

    clock = Clock()
    w = harness.Window(10.0, calls_before=1, clock=clock)
    r = harness.Recorder(8, 1)
    tap = harness.Tap(w, r)
    loglike = tap.wrap(lambda s: (s["a"] ** 2 * s["b"]))
    theta0 = torch.tensor([[0.5, 2.0], [1.5, -1.0]])
    for _ in range(2):
        th = theta0.clone().requires_grad_(True)
        sites = {"a": torch.exp(th[:, 0]), "b": th[:, 1]}
        u = -(th.sum(1) + loglike(sites))
        (g,) = torch.autograd.grad(u.sum(), th)
    assert w.count == 1 and 0 in w.exits
    (rec,) = r.items()
    assert torch.equal(rec.theta, theta0) and torch.equal(rec.ll, torch.exp(theta0[:, 0]) ** 2 * theta0[:, 1])
    a = torch.exp(theta0[:, 0])
    assert torch.allclose(rec.grads["a"], 2 * a * theta0[:, 1]) and torch.allclose(rec.grads["b"], a ** 2)
    assert torch.allclose(g[:, 0], -(1 + 2 * a ** 2 * theta0[:, 1]))
