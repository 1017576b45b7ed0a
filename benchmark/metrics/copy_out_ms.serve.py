"""The image's copy to the host a viewer request (ms): the device time of the
device-to-host copies inside the program's span `chs.request.copy_out`, the
mean over the slice's requests.  Nothing to read outside a serve slice or
without one such span a request."""

from benchmark import spans

COPIES = ("Memcpy DtoH",)


def read(t):
    outs = spans.host_spans(t, "chs.request.copy_out")
    if t.kind != "serve" or len(outs) != t.units:
        return None
    copies = spans.Busy(t, COPIES)
    return sum(copies.within(s, e) for s, e in outs) / len(outs) * 1e-3
