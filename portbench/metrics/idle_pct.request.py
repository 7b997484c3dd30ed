"""Share of the traced slice in which no kernel ran on the card, in %:
the slice is whole requests of the window (the traffic's
``trace_first_request`` and ``trace_requests``), decode and encode
included, and busy time is the union of the kernels' intervals."""


def read(r):
    if r.slice_s <= 0 or not r.kernels:
        return None
    return 100.0 * (1.0 - r.kernel_busy_s / r.slice_s)
