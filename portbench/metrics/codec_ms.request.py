"""Mean host milliseconds per request in the PNG decode and encode, from
the harness's spans around the program's codec calls, over the requests
of the traced slice."""


def read(r):
    n = r.counts.get("requests", 0)
    if n <= 0:
        return None
    return 1e3 * (r.span_s("decode") + r.span_s("encode")) / n
