"""Mean rows of the batches the dispatcher finished in the window (its
``dispatched`` list: requests and rows, pad rows not counted)."""


def read(run):
    rows = [r for _, r in run.dispatched]
    return sum(rows) / len(rows) if rows else None
