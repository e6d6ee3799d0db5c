"""Launches the host issued a `rotate` request: distinct correlation ids of
the device activity whose runtime call lies inside a `request.rotate` span,
over those requests."""

from hebench.metrics._common import launches_per_request


def read(t: dict):
    return launches_per_request(t, "rotate")
