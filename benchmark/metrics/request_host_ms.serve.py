"""The host's part of a viewer request (ms): the program's span
`chs.request` (camera, lock, launch, copy-out) less the device's busy time
inside it, the mean over the slice's requests.  Nothing to read outside a
serve slice or without one such span a request."""

from benchmark import spans


def read(t):
    requests = spans.host_spans(t, "chs.request")
    if t.kind != "serve" or len(requests) != t.units:
        return None
    busy = spans.Busy(t)
    return sum((e - s) - busy.within(s, e) for s, e in requests) / len(requests) * 1e-3
