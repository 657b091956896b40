"""Share of the traced window in which nothing ran on the device, in %
(1 - the union of device intervals / the window), in single-query cells."""


def read(ctx):
    r = ctx.reading
    if r is None or r.busy_s <= 0 or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
