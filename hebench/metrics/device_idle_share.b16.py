"""Share of the traced window in which no kernel, copy or fill ran on the
card (1 - the union of device activity over the window), in %."""

from hebench.metrics._common import idle_share


def read(t: dict):
    return idle_share(t)
