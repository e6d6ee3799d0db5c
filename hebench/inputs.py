"""Everything a run feeds the program, made from `--seed`.

One seed gives one secret key, one set of plaintexts and constants, one
generator for the encryptions on the card, and one order of requests.  Each
stream has a tag of its own (`stream`), so adding a stream changes no
other.  Every seed draws the same sizes and the same count of each
operation; only the values and the order differ.
"""

from __future__ import annotations

import numpy as np

STREAMS = {"key": 1, "plaintexts": 2, "constants": 3, "plan": 4,
           "encrypt": 5, "keygen": 6, "sample": 7}


def stream(seed: int, name: str) -> np.random.Generator:
    """The generator of one named stream of a seed (any non-negative int)."""
    ss = np.random.SeedSequence(entropy=int(seed),
                                spawn_key=(STREAMS[name],))
    return np.random.Generator(np.random.PCG64(ss))


def torch_seed(seed: int, name: str) -> int:
    """A 63-bit seed for a torch.Generator from a named stream."""
    return int(stream(seed, name).integers(0, 2 ** 63 - 1))


def secret_key(seed: int, n: int) -> np.ndarray:
    """n ternary coefficients: 0 with probability 1/2, +1 and -1 with 1/4
    each (HElib's sampleSmall)."""
    u = stream(seed, "key").integers(0, 4, n)
    return np.where(u == 0, -1, np.where(u == 1, 1, 0)).astype(np.int64)


def bgv_plaintexts(rng: np.random.Generator, count: int, phi: int, p: int):
    """count uniform polynomials of degree < phi(m) mod p, [count, phi]."""
    return rng.integers(0, p, (count, phi)).astype(np.int64)


def ckks_slots(rng: np.random.Generator, count: int, n_slots: int):
    """count vectors of real slots uniform in [-1, 1], [count, n_slots]."""
    return rng.uniform(-1.0, 1.0, (count, n_slots))


def cycle(rng: np.random.Generator, values: list, count: int) -> list:
    """`count` draws of `values`, each pass over them in a fresh order:
    every value gets an equal share of each whole pass."""
    out: list = []
    while len(out) < count:
        out.extend(values[i] for i in rng.permutation(len(values)))
    return out[:count]


class Reservoir:
    """A uniform sample of k of the items offered, drawn from rng
    (Vitter's algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item):
        """The item the sample no longer holds: `item` itself if it was not
        kept, the one it replaced, or None."""
        dropped = None
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            dropped = item
            if j < self.k:
                dropped, self.items[j] = self.items[j], item
        self.seen += 1
        return dropped
