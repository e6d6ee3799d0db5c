"""Device ms a ciphertext operation spends in kernels that are neither
NTT-family kernels nor copies: the ring ops (dcrt, ctxt.ks_digit_mac, the
Bluestein lift and CRT tail of ops/ntt), from the device trace."""

from hebench.metrics._common import clipped_ns, in_window, is_copy, is_ntt


def read(t: dict):
    evs = [e for e in in_window(t)
           if not is_ntt(e["name"]) and not is_copy(e["name"])]
    if not evs or not t.get("ops"):
        return None
    return sum(clipped_ns(e, t) for e in evs) / 1e6 / t["ops"]
