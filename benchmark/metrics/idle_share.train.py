"""idle_share.train: the share of the traced sub-window of training (the
first window epoch's mining and first steps) in which the card ran no
kernel, copy or fill, in % (lower is better)."""


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["traced_s"])
