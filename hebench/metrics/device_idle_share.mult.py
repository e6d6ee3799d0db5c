"""Share of the time of the `mult` requests (their `request.mult` spans)
in which none of the kernels, copies or fills they caused ran on the
card, in %."""

from hebench.metrics._common import request_idle_share


def read(t: dict):
    return request_idle_share(t, "mult")
