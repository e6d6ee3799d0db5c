"""Batched calls: one operation on `batch` ciphertexts a call, through the
operation's batched entry (`batched` in its file, under
`jitutil.lifted_jit`), calls back to back with at most `in_flight` of them
queued on the card, cycling through a pool of distinct fresh encryptions
at least `pool_min_bytes` large (so the card's cache cannot hold it).  A
closed loop: the caller waits for its results, as HElib's users do.

Mix parameters: op, batch, pool_min_bytes, in_flight, sample_calls (calls
kept for the reference, drawn from the seed), trace_count (calls in a
traced window).  End to end: `ops_per_s`, every ciphertext of every call
over all the window's seconds.
"""

from __future__ import annotations

import math
import time

import torch

from hebench import cells, counts, inputs
from hebench.trace import span

BYTES_PER_RESIDUE = 4


class Mix:
    def __init__(self, sch, mix: dict, seed: int):
        from helib_tpu_torch import jitutil
        self.sch, self.mix, self.seed = sch, mix, seed
        self.op = cells.op(sch.cfg["scheme"], mix["op"])
        self.batch = B = mix["batch"]
        ctx = sch.ctx
        one = 4 * B * ctx.L * ctx.n_eval * BYTES_PER_RESIDUE
        self.n_pool = max(2, math.ceil(mix["pool_min_bytes"] / one))
        rng = inputs.stream(seed, "plaintexts")
        self.values = sch.plaintexts(rng, 2 * B * self.n_pool)
        self.pool = []
        parts = [sch.encrypt(v) for v in self.values]
        for i in range(self.n_pool):
            a = parts[2 * B * i: 2 * B * i + B]
            b = parts[2 * B * i + B: 2 * B * (i + 1)]
            self.pool.append(tuple(torch.stack([p[j] for p in side])
                                   for side in (a, b) for j in (0, 1)))
        self.fn = jitutil.lifted_jit(self.op.batched(sch, B), *self.pool[0])
        for i in range(max(3, self.n_pool)):
            self.fn(*self.pool[i % self.n_pool])
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, count: int | None = None) -> dict:
        cuda = self.sch.ctx.device.type == "cuda"
        sample = inputs.Reservoir(self.mix["sample_calls"],
                                  inputs.stream(self.seed, "sample"))
        pending: list = []
        calls = 0
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < seconds
               and (count is None or calls < count)):
            i = calls % self.n_pool
            with span("call"):
                out = self.fn(*self.pool[i])
            sample.offer((i, out))
            calls += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > self.mix["in_flight"]:
                    with span("wait_in_flight"):
                        pending.pop(0).synchronize()
        with span("synchronize"):
            if cuda:
                torch.cuda.synchronize()
        t1 = time.perf_counter()
        return {"seconds": t1 - t0, "calls": calls,
                "attempted": calls * self.batch, "failed": 0,
                "sample": sample.items}

    def number(self, metric: str, res: dict):
        """`ops_per_s`, None for another name."""
        if metric == "ops_per_s":
            return res["attempted"] / res["seconds"]
        return None

    def stderr_line(self, res: dict) -> str:
        return f"{res['calls']} calls of {self.batch}"

    def trace_facts(self, res: dict) -> dict:
        """What the readers need besides the trace: the calls and
        operations of the window and, where the operation lists its
        transforms, their least time a call (hebench/counts.py, from the
        configuration's sizes)."""
        facts = {"calls": res["calls"], "ops": res["attempted"]}
        if hasattr(self.op, "transforms"):
            facts["transform_bound_ms_per_call"] = counts.transform_bound_ms(
                self.sch.cfg, self.batch, self.op.transforms)
        return facts

    def judged(self, sample: list) -> list:
        """Each sampled call as reference items: one per batch element."""
        B, items = self.batch, []
        for i, (o0, o1) in sample:
            h0, h1 = o0.cpu(), o1.cpu()
            for j in range(B):
                items.append({
                    "op": self.mix["op"],
                    "a": self.values[2 * B * i + j],
                    "b": self.values[2 * B * i + B + j],
                    "out": self.op.batched_out(self.sch.cfg, h0[j], h1[j])})
        return items
