"""One file a kind of traffic, `<kind>.py`, found by the `kind` of a mix:
its `Mix` builds the pool, warms every shape, drives the window and hands
the reference what the window produced."""
