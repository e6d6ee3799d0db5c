"""One file an operation of a scheme, `<scheme>.<op>.py`, found by name: the
call into the program (`run`, and `batched` where a batched entry exists)
and the answer the plain reference expects (`expected`)."""
