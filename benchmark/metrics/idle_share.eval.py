"""idle_share.eval: the share of the traced pass's wall time in which the
card ran no kernel, copy or fill, in % (lower is better)."""


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["traced_s"])
