"""The host's time between training steps (ms): from the end of one step's
host read (the program's span `chs.step.read`, which waits for the card, so
the card has nothing queued) to the start of the next step's launch (its
span `chs.step.launch`), the mean over the slice's consecutive steps.
Nothing to read outside a train slice or without one of each span a step."""

from benchmark import spans


def read(t):
    reads = spans.host_spans(t, "chs.step.read")
    launches = spans.host_spans(t, "chs.step.launch")
    if t.kind != "train" or t.units < 2 or not len(reads) == len(launches) == t.units:
        return None
    gaps = [nxt[0] - done[1] for done, nxt in zip(reads, launches[1:])]
    if min(gaps) < 0:
        return None
    return sum(gaps) / len(gaps) * 1e-3
