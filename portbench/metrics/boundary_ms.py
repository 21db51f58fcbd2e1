"""``boundary_ms``: device ms a call in the layout copies and concatenations
(PyTorch's copy and cat kernels, device-to-device memcpy) that the call into
the program issued: the API boundary's (…, n) ↔ (n, B) copies and the
concatenation of ∇FD's and ∂ID's two halves. From the device trace."""


def read(r):
    if r.timeline is None or not r.calls or not r.timeline.api_s:
        return None
    return r.timeline.boundary_s / r.calls * 1e3
