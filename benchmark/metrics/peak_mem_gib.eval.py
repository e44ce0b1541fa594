"""peak_mem_gib.eval: ``torch.cuda.max_memory_allocated()`` over the run
up to the close of the window, in GiB (lower is better)."""


def read(ctx):
    return ctx["peak_bytes"] / 2.0 ** 30
