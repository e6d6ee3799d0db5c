"""One request at a time: one client sends each operation of `ops` through
the `Ctxt` API and waits for it, each on fresh ciphertexts of a pool of
`pool`.  Every block of len(ops) requests holds each operation once, in an
order drawn from the seed, so each operation gets an equal share of the
requests and its own latency: HElib's bgv_basic and ckks_basic time each
operation on its own, and so does this kind.  A request is timed on the
host from its issue to a synchronize after it.

Mix parameters: ops, pool, constants (seeded plaintexts for `mul_plain`),
plan_len (requests planned; a window ends at its seconds first), sample
(requests kept for the reference, drawn from the seed), trace_count
(requests in a traced window).  End to end: `<op>_p<q>_ms`, the q-th
percentile of the latencies of every request of `op` in the window, for
any `op` of the mix and any q.

Spans: `request.<op>` around a request, inside it `op.<op>` (the program's
call) and `synchronize`; `keep` copies a sampled output to the host,
outside every request.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

from hebench import cells, inputs
from hebench.port import host_parts
from hebench.trace import span

PERCENTILE = re.compile(r"^(?P<op>.+)_p(?P<q>\d+)_ms$")


class Mix:
    def __init__(self, sch, mix: dict, seed: int):
        self.sch, self.mix, self.seed = sch, mix, seed
        self.ops = {name: cells.op(sch.cfg["scheme"], name)
                    for name in mix["ops"]}
        self.values = sch.plaintexts(inputs.stream(seed, "plaintexts"),
                                     mix["pool"])
        self.consts = sch.plaintexts(inputs.stream(seed, "constants"),
                                     mix["constants"])
        self.pool = [sch.wrap(sch.encrypt(v), v) for v in self.values]
        self.rng = inputs.stream(seed, "plan")
        self.rots = sch.rotations or [0]
        # warm-up: each operation over every value of what it varies (a
        # constant, a rotation), then every operation twice, so each
        # shape the mix uses is built and captured before the window
        for name, op in self.ops.items():
            warm = getattr(op, "WARM", None)
            if warm == "const":
                args = [(j, self.rots[0]) for j in range(len(self.consts))]
            elif warm == "amt":
                args = [(0, r) for r in self.rots]
            else:
                args = [(0, self.rots[0])]
            for c, amt in args:
                self.request(name, 0, 1, c, amt)
        for _ in range(2):
            for name in self.ops:
                self.request(name, 0, 1, 0, self.rots[0])

    def request(self, name: str, a: int, b: int, c: int, amt: int):
        with span("request." + name):
            with span("op." + name):
                out = self.ops[name].run(self.sch, self.pool[a], self.pool[b],
                                         self.consts[c], amt)
            with span("synchronize"):
                if self.sch.ctx.device.type == "cuda":
                    torch.cuda.synchronize()
        return out

    def window(self, seconds: float, count: int | None = None) -> dict:
        n_plan = count or self.mix["plan_len"]
        plan = inputs.cycle(self.rng, list(self.ops), n_plan)
        pairs = self.rng.integers(0, len(self.pool), (n_plan, 2))
        pairs[:, 1] = (pairs[:, 0] + 1 + pairs[:, 1] % (len(self.pool) - 1)
                       ) % len(self.pool)
        consts = inputs.cycle(self.rng, list(range(len(self.consts))),
                              n_plan)
        amts = inputs.cycle(self.rng, self.rots, n_plan)
        sample = inputs.Reservoir(self.mix["sample"],
                                  inputs.stream(self.seed, "sample"))
        lat, names, failed = [], [], 0
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds and n < n_plan:
            name, (a, b) = plan[n], pairs[n]
            item = {"op": name, "a": int(a), "b": int(b), "c": consts[n],
                    "amt": amts[n], "out": None}
            s = time.perf_counter()
            try:
                out = self.request(name, a, b, consts[n], amts[n])
            except (RuntimeError, ValueError, ArithmeticError):
                failed += 1
                out = None
            lat.append(time.perf_counter() - s)
            names.append(name)
            # a kept output goes to host memory at once, outside its
            # request, so the card's peak does not follow the draw
            if sample.offer(item) is not item and out is not None:
                with span("keep"):
                    item["out"] = host_parts(out)
            n += 1
        t1 = time.perf_counter()
        return {"seconds": t1 - t0, "requests": n, "attempted": n,
                "failed": failed, "latencies": lat, "ops": names,
                "sample": sample.items}

    def by_op(self, res: dict) -> dict:
        """The window's latencies in ms by operation."""
        out: dict = {name: [] for name in self.ops}
        for name, dt in zip(res["ops"], res["latencies"]):
            out[name].append(dt * 1e3)
        return out

    def number(self, metric: str, res: dict):
        """`<op>_p<q>_ms` for any q, None for another name."""
        m = PERCENTILE.match(metric)
        lat = self.by_op(res).get(m["op"]) if m else None
        return float(np.percentile(lat, int(m["q"]))) if lat else None

    def trace_facts(self, res: dict) -> dict:
        return {"requests": res["requests"]}

    def judged(self, sample: list) -> list:
        return [{"op": it["op"], "a": self.values[it["a"]],
                 "b": self.values[it["b"]], "const": self.consts[it["c"]],
                 "amt": it["amt"], "out": it["out"]} for it in sample]

    def stderr_line(self, res: dict) -> str:
        return "ms by operation (count, p50, p95): " + ", ".join(
            f"{k} {len(v)} {np.percentile(v, 50):.3f} "
            f"{np.percentile(v, 95):.3f}"
            for k, v in self.by_op(res).items() if v)
