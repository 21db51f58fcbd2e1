"""``launches_per_call``: the rise of the program's own launch counter
(``sum(_launch.LAUNCHES.values())``) over the window, per completed call:
how many of its CUDA kernels the routing ran for one call."""


def read(r):
    if not r.calls:
        return None
    return r.launches / r.calls
