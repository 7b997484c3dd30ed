"""Share of the traced slice in which no kernel ran on the card, in %:
the slice is whole `upscale_batch` calls of the window (the traffic's
``trace_first_call`` and ``trace_calls``), and busy time is the union
of the kernels' intervals (copies are not kernels)."""


def read(r):
    if r.slice_s <= 0 or not r.kernels:
        return None
    return 100.0 * (1.0 - r.kernel_busy_s / r.slice_s)
