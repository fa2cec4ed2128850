"""Device time of the kernels that ran under no program op, a job: the
step's torch glue, the SGD update and the eval where it is plain torch."""


def read(ctx):
    tr = ctx.trace
    if not tr.units or not tr.kernels:
        return None
    us = sum(k.end - k.start for k in tr.kernels if k.op is None)
    return us * 1e-3 / tr.units
