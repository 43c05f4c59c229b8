"""Device milliseconds of the copies between cards (``Memcpy PtoP``: the
scene's copies and the sum onto the first card) per traced job; nothing
where no such copy ran."""

PART = "Memcpy PtoP"


def read(t):
    jobs = sum(s.role == "render" for s in t.segments)
    s = t.device_s(PART)
    if not jobs or s <= 0:
        return None
    return 1e3 * s / jobs
