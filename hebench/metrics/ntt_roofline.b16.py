"""Share of their roofline the NTT-family kernels (K1 at odd m, K2 at
power-of-2 m) reach: the least time of the transforms a call needs
(hebench/counts.py, from the configuration's sizes) over the device time
of those kernels, per call, in %."""

from hebench.metrics._common import clipped_ns, in_window, is_ntt


def read(t: dict):
    ns = sum(clipped_ns(e, t) for e in in_window(t) if is_ntt(e["name"]))
    bound = t.get("transform_bound_ms_per_call")
    if not ns or not bound or not t.get("calls"):
        return None
    return 100.0 * bound * t["calls"] / (ns / 1e6)
