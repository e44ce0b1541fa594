"""mining_images_per_s.train: the images mined in the window's epochs
over the program's own stopwatch of mining (the ``prepare_data`` lap that
``SupervisedEpoch`` logs as ``learning/prepare_epoch``)."""


def read(ctx):
    if ctx["prepare_s"] <= 0:
        return None
    return ctx["mined_images"] / ctx["prepare_s"]
