"""Share of the traced slice that the training loop spent waiting in
the harness's span around `CropPipeline.next_batch`, in %."""


def read(r):
    if r.slice_s <= 0:
        return None
    return 100.0 * r.span_s("feed_wait") / r.slice_s
