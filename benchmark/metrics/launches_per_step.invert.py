"""Device kernels launched a SGD step: the profiler's count of kernels in
the traced jobs over their steps (each step's glue, its CG op and its
update, and the job's eval spread over its steps)."""


def read(ctx):
    steps = ctx.trace.units * ctx.work["steps"]
    if not steps or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / steps
