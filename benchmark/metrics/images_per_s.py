"""Images answered for every request sent in the window, over the seconds
from the window's opening to the last of those answers. Requests in
flight at the close are waited for and counted, so all the window's work
and all its time are in the rate: a stall anywhere in it, its tail
included, moves it, and a merged batch answered just after the close is
counted with the time it took. The fill at the opening, before the first
batch is answered, stays in."""


def read(run):
    if not run.records:
        return None
    last = max(r["t_done"] for r in run.records)
    return sum(len(r["images"]) for r in run.records) / (last - run.t0)
