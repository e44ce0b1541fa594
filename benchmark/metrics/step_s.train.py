"""step_s.train: the mean of the program's own ``process_batch`` laps
(``learning/iteration``) over the window's steps, in s (lower is
better)."""


def read(ctx):
    laps = ctx["process_s"]
    return sum(laps) / len(laps) if laps else None
