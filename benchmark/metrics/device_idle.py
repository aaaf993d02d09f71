"""Share of the traced window in which nothing ran on the card (no kernel,
copy or set), from torch.profiler's device events."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * max(t.window_s - t.busy_s, 0.0) / t.window_s
