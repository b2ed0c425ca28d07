"""Device idle share of the traced window: 1 - busy / window, in percent
(busy: the union of the device's activities inside the window)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
