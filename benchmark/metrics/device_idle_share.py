"""The device's idle share of the traced slice: 1 - (the union of every
device operation's interval) / (the slice's wall time); rank 0's card
in a cell of several."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
