"""``<mix>_roofline``: the share of its roofline at which the program's own
kernels run one call of the entry, in %.

The bound is the least time the card could take for the entry's work, the
larger of its operations over the float32 peak and its bytes over the
memory peak (``peaks.json``): the operations a state as the frozen count
(``counts/<config>.<entry>.json``) gives them times the batch, the bytes a
state reading each input once and writing each output once. It is taken
over the whole entry, not a kernel, so it reads the same work whatever
kernels do it. The time is the device time a call of the program's own
operations took: every device operation the call issued but the boundary's
layout copies. ``BENCHMARK.json``'s ``workloads`` list says which cells
read which roofline; without a device trace it is left out."""


def read(r):
    tl = r.timeline
    if tl is None or not r.calls or tl.program_s <= 0 or not r.peaks:
        return None
    ops = r.counts["ops_per_state"] * r.batch
    nbytes = r.counts["bytes_per_state"] * r.batch
    bound_s = max(ops / r.peaks["float32_flops"],
                  nbytes / r.peaks["bytes_per_s"])
    return 100.0 * bound_s / (tl.program_s / r.calls)
