"""Compiled dispatch: a callable over fixed shapes run as one CUDA-graph
replay (helib_tpu.jitutil).

helib_tpu compiles its hot compound ops into one program each
(`lifted_jit`): the batched mult+relin (bench.py), every transform
(Context._ntt_call), the digit decomposition and the scaled mod-down
(dcrt._jit_call), decrypt's inner product (SecKey._inner_product_residues).
PyTorch's counterpart of one compiled program over fixed shapes and
device-resident tables is a CUDA graph: the function's kernels are captured
once and replayed as one launch.  `lifted_jit(fn, *example_args)` returns
`run(*args)`:

  * on CUDA tensors, the first call of each signature (the arguments'
    shapes, dtypes and device, and the kernel entry points the port
    dispatches to, `dispatch_key`) runs fn once on a side stream -- which
    builds the kernels and fills every cache fn reads, so the capture finds
    its tables on the device -- returns that call's outputs, and captures fn
    into a torch.cuda.CUDAGraph over static copies of the arguments; every
    later call copies its arguments into them, replays, and returns clones
    of the outputs (a jit returns fresh arrays, and callers feed outputs
    back in as inputs);
  * on CPU tensors run is fn itself: the host path is the one held to
    helib_tpu, and it runs eagerly.

Under `disable_jit()` (jax.disable_jit's twin), while another run warms up
or captures (helib_tpu's sites see tracers then), and while the current
stream is capturing, a run calls fn directly.  A captured graph keeps what fn
read at capture: its tables live in the context's caches, as helib_tpu's
lifted constants are kept by reference.

Every graph shares one memory pool a device (torch.cuda.graph_pool_handle,
held for the process): a graph's static inputs and outputs are held for its
lifetime, so a later capture reuses only the intermediates of earlier ones,
which is safe while the graphs replay one after another on one stream, as
every caller here does.  The launch counts a kernel wrapper keeps in
Python (`launch_counters`) are incremented by Python code that a replay
skips, so each run records their change during its capture and adds it
again on every replay.  A capture or replay error raises; nothing falls
back to eager dispatch.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

_disabled = 0        # disable_jit() depth
_tracing = 0         # runs warming up or capturing (their inner sites run fn)
_pools: dict = {}    # device index -> (graph_pool_handle(), its keeper)
_streams: dict = {}  # device index -> the side stream of warm-ups and captures
captures = 0         # graphs captured in this process
replays = 0          # replays in this process
warmup_s = 0.0       # host seconds in warm-up calls (the first call's work)
capture_s = 0.0      # host seconds capturing and instantiating


@contextlib.contextmanager
def disable_jit():
    """Every site runs its function eagerly while this is open (nests)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def jit_enabled() -> bool:
    return _disabled == 0


# ---------------------------------------------------------------------------
# the launch counts a replay has to keep true (pure Python bookkeeping)
# ---------------------------------------------------------------------------

_counters: list = []


def launch_counters() -> list:
    """(holder, attribute) of every count the port keeps in Python beside a
    launch: each kernel wrapper's `.launches`, ops.ntt.staged_transforms and
    parallel.sharded_ntt.sharded_transforms."""
    if not _counters:
        from .ops import conv, ntt, ntt2, ntt_fused, probes
        from .parallel import sharded_ntt
        _counters.extend([
            (conv.conv_cuda, "launches"), (conv.conv_aux_cuda, "launches"),
            (ntt_fused.ntt_cuda, "launches"), (ntt2.ntt2_cuda, "launches"),
            (ntt2.conv2_cuda, "launches"), (probes.p1_cuda, "launches"),
            (probes.p2_cuda, "launches"), (ntt, "staged_transforms"),
            (sharded_ntt, "sharded_transforms")])
    return _counters


def read_counts(counters) -> tuple:
    return tuple(getattr(h, a) for h, a in counters)


def set_counts(counters, values) -> None:
    for (h, a), v in zip(counters, values):
        setattr(h, a, v)


def add_counts(counters, delta) -> None:
    """Adds a capture's change of each count (what one replay launches)."""
    for (h, a), d in zip(counters, delta):
        if d:
            setattr(h, a, getattr(h, a) + d)


def count_delta(before, after) -> tuple:
    return tuple(b - a for a, b in zip(before, after))


def dispatch_key() -> tuple:
    """The kernel entry points a transform dispatches to and the v2
    switch: a graph captured with one set replays only under the same set,
    so a plain version swapped in for a check, or HELIB_NTT_V2, captures a
    graph of its own."""
    from .ops import conv, ntt, ntt2, ntt_fused
    return (conv.conv, conv.conv_aux, ntt_fused.ntt, ntt.staged_conv,
            ntt.staged_pow2, ntt2.ntt_v2())


# ---------------------------------------------------------------------------
# outputs: nested tuples/lists of tensors (and static Python values)
# ---------------------------------------------------------------------------

def _flatten(out, leaves: list):
    """The tensors of `out` appended to `leaves`; returns the skeleton that
    `_rebuild` fills again."""
    if isinstance(out, torch.Tensor):
        leaves.append(out)
        return None
    if isinstance(out, (tuple, list)):
        return (type(out), [_flatten(o, leaves) for o in out])
    return ("value", out)


def _rebuild(skel, it):
    if skel is None:
        return next(it)
    kind, body = skel
    if kind == "value":
        return body
    return kind(_rebuild(s, it) for s in body)


@contextlib.contextmanager
def _no_gc():
    """No cyclic garbage collection while capturing: a collected graph's
    destructor would end the capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _index(device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def pool(device: torch.device):
    """The memory pool every graph on `device` shares, held for the
    process by a one-node keeper graph: PyTorch cannot capture into a pool
    again once every graph that used it is gone."""
    idx = _index(device)
    if idx not in _pools:
        handle = torch.cuda.graph_pool_handle()
        keeper = torch.cuda.CUDAGraph()
        side, cur = _side_stream(device), torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), _no_gc():
            keeper.capture_begin(pool=handle,
                                 capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            keeper.capture_end()
        cur.wait_stream(side)
        _pools[idx] = (handle, keeper)
    return _pools[idx][0]


def pool_bytes(device) -> int:
    """Device memory the shared pool of `device` holds (its segments)."""
    held = _pools.get(_index(device))
    if held is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id") or ()) == tuple(held[0]))


def _retire(device) -> None:
    """After a failed capture PyTorch's allocators may still route the
    capture stream's allocations to its pool: later captures take a fresh
    pool and a fresh stream."""
    _pools.pop(_index(device), None)
    _streams.pop(_index(device), None)


def _side_stream(device: torch.device):
    idx = _index(device)
    if idx not in _streams:
        _streams[idx] = torch.cuda.Stream(device)
    return _streams[idx]


class _Graph:
    """One captured signature: the graph, its static inputs and outputs, and
    the launch counts one replay adds."""

    def __init__(self, fn, args, device):
        global captures, warmup_s, capture_s
        counters = launch_counters()
        handle = pool(device)
        self.static_in = [a.clone() for a in args]
        side, cur = _side_stream(device), torch.cuda.current_stream(device)
        side.wait_stream(cur)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            # the warm-up: builds the kernels, fills the caches fn reads and
            # gives the first call's outputs (real launches, so counted)
            t0 = time.perf_counter()
            self.first = fn(*args)
            t1 = time.perf_counter()
            warmup_s += t1 - t0
            before = read_counts(counters)
            reserved = torch.cuda.memory_reserved(device)
            try:
                with _no_gc():
                    self.graph.capture_begin(
                        pool=handle, capture_error_mode="thread_local")
                    try:
                        out = fn(*self.static_in)
                    except BaseException:
                        with contextlib.suppress(Exception):
                            self.graph.capture_end()
                        raise
                    self.graph.capture_end()
            except BaseException:
                _retire(device)
                raise
            finally:
                # the capture launched nothing; a replay launches this
                self.delta = count_delta(before, read_counts(counters))
                set_counts(counters, before)
        capture_s += time.perf_counter() - t1
        cur.wait_stream(side)
        self.leaves: list = []
        self.skel = _flatten(out, self.leaves)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        captures += 1

    def replay(self, args):
        global replays
        for s, a in zip(self.static_in, args):
            s.copy_(a)
        self.graph.replay()
        replays += 1
        add_counts(launch_counters(), self.delta)
        return _rebuild(self.skel, (t.clone() for t in self.leaves))


def _on_card(args) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else (no
    tensor, a sequence, a mix of devices) raises TypeError."""
    cuda = {isinstance(a, torch.Tensor) and a.is_cuda for a in args}
    if not args or len(cuda) != 1 or not all(
            isinstance(a, torch.Tensor) for a in args):
        raise TypeError("a compiled function takes tensors, all on the card "
                        "or all on the host: got " + ", ".join(
                            type(a).__name__ if not isinstance(
                                a, torch.Tensor) else str(a.device)
                            for a in args))
    return cuda.pop()


def _eager(args) -> bool:
    """Whether a call on `args` runs its function directly."""
    return (not _on_card(args) or _disabled or _tracing
            or torch.cuda.is_current_stream_capturing())


def lifted_jit(fn, *example_args):
    """`run(*args)`: fn over tensor arguments as one CUDA-graph replay a
    call, one graph a signature (see the module docstring); fn itself when
    the example arguments lie on the CPU.  run.captures counts its graphs,
    run.pool_bytes the pool memory their captures added."""
    if not _on_card(example_args):
        return fn
    graphs: dict = {}

    def run(*args):
        global _tracing
        if _eager(args):
            return fn(*args)
        sig = (tuple((tuple(a.shape), a.dtype, a.device) for a in args),
               dispatch_key())
        entry = graphs.get(sig)
        if entry is not None:
            return entry.replay(args)
        _tracing += 1
        try:
            entry = _Graph(fn, args, args[0].device)
        finally:
            _tracing -= 1
        graphs[sig] = entry
        run.captures += 1
        run.pool_bytes += entry.pool_bytes
        first, entry.first = entry.first, None
        return first

    run.captures = 0
    run.pool_bytes = 0
    run.graphs = graphs
    return run


def jit_call(cache: dict, key, builder, *args):
    """helib_tpu's _jit_call: the cached run of `builder()` for the static
    configuration `key`, called on args; builder()(*args) itself where a
    run would call it directly (CPU tensors, disable_jit, inside another
    run's warm-up or capture)."""
    if _eager(args):
        return builder()(*args)
    run = cache.get(key)
    if run is None:
        run = cache[key] = lifted_jit(builder(), *args)
    return run(*args)
