"""The device's idle share of the traced serve slice (%): one minus the
union of its kernel, copy and set intervals over the slice's wall time."""


def read(t):
    if t.kind != "serve" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
