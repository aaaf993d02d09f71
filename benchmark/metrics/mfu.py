"""The whole request's share of the card's bf16 peak: the model FLOPs of
the real rows of every chunk run in the traced window (flops.py, from the
configuration), over the window's seconds times 989 TFLOP/s."""

from benchmark import flops, peaks


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    _, useful = flops.traced(run)
    if useful <= 0:
        return None
    return 100.0 * useful / (run.trace.window_s * peaks.BF16_FLOPS)
