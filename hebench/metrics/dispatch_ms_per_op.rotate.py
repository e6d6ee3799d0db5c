"""Host ms a `rotate` request spends in the program's Python and kernel
launches: as `dispatch_ms_per_op.mult`, over the `rotate` requests."""

from hebench import cells


def read(t: dict):
    return cells._module("metrics", "dispatch_ms_per_op.mult").dispatch_ms(
        t, "rotate")
