"""Device ms a `rotate` request spends in its key switch: as
`keyswitch_ms_per_op.mult`, over the `rotate` requests."""

from hebench import cells


def read(t: dict):
    return cells._module("metrics", "keyswitch_ms_per_op.mult").keyswitch_ms(
        t, "rotate")
