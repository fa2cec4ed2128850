"""The readers that more than one per-layer metric uses: each metric's own
module (``<metric>.py``) names one of these as its ``read``."""

import statistics

from benchmark import work


def cg_roofline(ctx):
    """100 × least time of the ops' CG work / device time under the ops:
    the least time the card could take for the CG work of every program op
    call in the traced units (``work.op_call_work``: solves × iterations ×
    nodes, the frozen operations and bytes a node and iteration, at the
    published peaks) over the device time of the kernels launched under the
    program's ops.  None where the trace holds no kernel under an op, or
    where a program op whose kernels the denominator holds has a call whose
    work the frozen table cannot count (a renamed op, or its arguments
    moved): the work would then be counted short, so nothing is read."""
    trace = ctx.trace
    busy_us = sum(k.end - k.start for k in trace.kernels if k.op is not None)
    if busy_us <= 0.0:
        return None
    launched = {k.op for k in trace.kernels if k.op is not None}
    counted = set()
    least = 0.0
    for call in trace.op_calls:
        w = work.op_call_work(call.name, call.concrete_inputs,
                              call.input_dims)
        if w is None:
            if call.name in launched:
                return None
            continue
        counted.add(call.name)
        least += work.least_seconds(*w)
    if launched - counted:
        return None
    return 100.0 * least / (busy_us * 1e-6)


def idle_pct(ctx):
    """The share of the traced window in which no kernel, copy or fill ran
    on the device (the union of their intervals taken from the window)."""
    tr = ctx.trace
    if tr.window_s <= 0.0 or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(ctx):
    """The whole traced window's share of the card's float32 peak: the
    operations of every CG solve the traced units ran (the traffic kind's
    ``unit_work``, at the frozen operations a node and iteration, whether
    the solve runs in a kernel or in torch) over the window's time × 67
    TFLOP/s."""
    tr, w = ctx.trace, ctx.work
    if not tr.units or tr.window_s <= 0.0 or not tr.kernels:
        return None
    ops = tr.units * work.cg_operations(w["dim"], w["cg_node_iterations"], 1)
    return 100.0 * ops / (tr.window_s * work.PEAK_F32_FLOPS)


def host_ms_per_call(ctx):
    """The host's time in one call, from the call until it returns (the
    kernels enqueued, before the caller waits for the answer): the median
    over the window's untraced calls, on the host's clock."""
    if not ctx.host_s:
        return None
    return 1e3 * statistics.median(ctx.host_s)
