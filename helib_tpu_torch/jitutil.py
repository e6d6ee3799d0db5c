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
every caller here does.  The port's launch counts (ops._build.launch_counts)
are kept by Python code that a replay skips, so each run records their
change during its capture and adds it again on every replay.  A capture or
replay error raises; nothing falls back to eager dispatch.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from .ops import _build
from .timing import timer

_disabled = 0        # disable_jit() depth
_tracing = 0         # runs warming up or capturing (their inner sites run fn)
_pools: dict = {}    # device index -> (graph_pool_handle(), its keeper)
_streams: dict = {}  # device index -> the side stream of warm-ups and captures
captures = 0         # graphs captured in this process
replays = 0          # replays in this process


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


def dispatch_key() -> tuple:
    """The kernel entry points a transform and the basis extension
    dispatch to, and the v2 switch: a graph captured with one set replays
    only under the same set, so a plain version swapped in for a check, or
    HELIB_NTT_V2, captures a graph of its own."""
    from .ops import basis_ext, conv, ntt, ntt2, ntt_fused
    return (conv.conv, conv.conv_aux, ntt_fused.ntt, ntt.staged_conv,
            ntt.staged_pow2, ntt2.ntt_v2(), basis_ext.basis_ext_cuda)


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
        global captures
        handle = pool(device)
        self.static_in = [a.clone() for a in args]
        side, cur = _side_stream(device), torch.cuda.current_stream(device)
        side.wait_stream(cur)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            # the warm-up: builds the kernels, fills the caches fn reads and
            # gives the first call's outputs (real launches, so counted)
            with timer("jitutil.warmup"):
                self.first = fn(*args)
            reserved = torch.cuda.memory_reserved(device)
            # the capture launched nothing; a replay launches what it counted
            try:
                with timer("jitutil.capture"), _no_gc(), \
                        _build.counted_apart() as self.delta:
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
        cur.wait_stream(side)
        self.leaves: list = []
        self.skel = _flatten(out, self.leaves)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        captures += 1

    def replay(self, args):
        global replays
        with timer("jitutil.replay"):
            for s, a in zip(self.static_in, args):
                s.copy_(a)
            self.graph.replay()
            replays += 1
            _build.launch_counts.update(self.delta)
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
