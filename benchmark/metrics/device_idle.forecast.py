"""The device's idle share over the traced window of a forecast cell: one minus the union of
its kernel, memcpy and memset intervals, over the window."""


def read(r):
    return 100.0 * r.idle_share
