"""CUDA graphs per padded structure: the port's counterpart of ``jax.jit``.

The reference compiles the planned two-site matvec and the fused
environment update once per (power-of-two padded) block structure and
replays the executable.  On the card that is a CUDA graph: the whole
pipeline of one structure — every bucket's stack, gather and block GEMM
launch, the segment sums, the reshapes — is captured once and then issued
with one host call per replay.

``GraphCache.run(key, body, prepare, live, fixed)`` computes
``body(fixed_views, live_views, keep) -> outputs`` for the structure
``key``:

- ``prepare()`` runs before the capture of a new structure: it builds the
  structure's plans and work lists and uploads their index tables (a copy
  from the host cannot be captured), and returns the outputs' shapes, a
  ``meta`` value the caller gets back with every result, and ``keep``:
  what ``body`` reads besides its inputs (the plans, which own the device
  tables).  The structure's entry holds ``keep`` for as long as its graph
  lives, since the graph reads those tables by address: the plan caches
  may evict them meanwhile, and their memory must not be reused while a
  replay can still read it.
- Inputs are read from static buffers: each call copies its tensors into
  one flat buffer per role with one ``torch.cat`` (``live``: every call;
  ``fixed``: only when ``fixed_token`` names other contents than the buffer
  holds, i.e. once per Davidson solve for the matvec's fixed operands), and
  ``body`` sees views into it.  A structure's entry takes the cache's
  buffers at its first call and keeps them: later structures share them
  while they are large enough, and a structure that needs more allocates
  larger ones (twice the size at least) for itself and the structures after
  it.  A graph keeps reading the buffers it was captured on, so a growth
  drops no graph and a warmed pipeline never captures again.
- The outputs are concatenated into a static output buffer inside the
  graph, and every call returns a copy of it (one copy), since callers keep
  results across calls (Davidson keeps every ``A v``).
- All graphs allocate their intermediates from one shared memory pool.
  That is safe because no graph's data outlives its replay: inputs and
  outputs live in the static buffers, outside the pool, and each output is
  copied out before the next replay.
- The first call of a structure captures its graph on a side stream and
  replays it; later calls replay it.  A capture that fails raises, on that
  call and on every later call of the structure; nothing runs eagerly
  instead.
- Kernel launches made during a capture are recorded for its graph
  (``kernels.recording``) and counted on every replay
  (``kernels.count_replay``), so ``kernels.LAUNCHES`` counts what ran.

On the CPU the same class stages the same buffers and runs ``body``
eagerly in place of each replay, with the same caching and counters, and
checks the outputs against ``prepare``'s shapes.
"""
from __future__ import annotations

import gc
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from .. import kernels

Body = Callable[[List[torch.Tensor], List[torch.Tensor], Any], Sequence[torch.Tensor]]
Prepare = Callable[[], Tuple[Sequence[Tuple[int, ...]], Any, Any]]
# structures kept, least recently used evicted first
MAX_GRAPHS = 256


def capturing(t: torch.Tensor) -> bool:
    """Whether work on ``t`` is being captured into a CUDA graph now (never
    on the CPU, where the query does not exist)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _layout(shapes) -> Tuple[Tuple[Tuple[int, ...], ...], Tuple[int, ...], int]:
    """``(shapes, offsets, numel)`` of tensors laid end to end."""
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    offs, acc = [], 0
    for s in shapes:
        offs.append(acc)
        n = 1
        for d in s:
            n *= d
        acc += n
    return shapes, tuple(offs), acc


def _views(buf: torch.Tensor, layout) -> List[torch.Tensor]:
    shapes, offs, numel = layout
    ends = offs[1:] + (numel,)
    return [buf[o:e].view(s) for s, o, e in zip(shapes, offs, ends)]


class _Entry:
    """One structure: its input and output layouts, ``meta``, what its
    body reads besides its inputs (``keep``), the static buffers it reads
    and writes (``bufs``, by role), and on the card its graph and the
    launches its capture recorded."""

    __slots__ = ("graph", "tally", "captured", "meta", "keep", "fixed", "live", "out", "bufs")

    def __init__(self, fixed, live, out, meta, keep):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tally: Dict = {}
        self.captured = False
        self.fixed, self.live, self.out, self.meta, self.keep = fixed, live, out, meta, keep
        self.bufs: Dict[str, "_Buffer"] = {}


class _Buffer:
    """One flat static buffer, and for a ``fixed`` one the token of the
    contents staged in it."""

    __slots__ = ("tensor", "token")

    def __init__(self, tensor: torch.Tensor):
        self.tensor, self.token = tensor, None


class GraphCache:
    """CUDA graphs of pipelines, one per structural key, LRU-bounded.

    ``max_graphs`` bounds the structures kept (least recently used evicted
    first).  Device memory does not grow with it: the graphs share one pool
    and one set of static buffers, sized by the largest structure.

    ``stats()``: ``graph_captures`` (structures captured, the port's ``jit_retraces``),
    ``graph_replays``, ``graphs`` (structures kept), ``evictions``,
    ``buffer_growths`` (static buffers allocated larger than the last),
    ``buffer_bytes`` (the static buffers live), ``pool_bytes`` (growth of the
    card's reserved memory over the captures: the shared pool's segments),
    ``capture_seconds`` (host time of the captures, instantiation included)
    and ``instantiate_seconds`` (of which in ``capture_end``).
    """

    def __init__(self):
        self.max_graphs = MAX_GRAPHS
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        # the newest (largest) buffer per (role, device, dtype); older ones
        # live on in the entries captured on them
        self._buffers: Dict[Tuple[str, torch.device, torch.dtype], _Buffer] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._anchor: Optional[torch.cuda.CUDAGraph] = None
        self.captures = self.replays = self.evictions = self.buffer_growths = 0
        self.pool_bytes = 0
        self.capture_seconds = self.instantiate_seconds = 0.0

    # ---------------------------------------------------------------- buffers
    def _buffer(self, role: str, numel: int, like: torch.Tensor) -> _Buffer:
        """The newest buffer of ``role``, or a larger one when it holds
        fewer than ``numel`` elements (the old one stays with its entries)."""
        key = (role, like.device, like.dtype)
        buf = self._buffers.get(key)
        if buf is None or buf.tensor.numel() < numel:
            if buf is not None:
                self.buffer_growths += 1
            size = max(numel, 2 * buf.tensor.numel() if buf is not None else 0, 1)
            buf = self._buffers[key] = _Buffer(torch.empty(size, dtype=like.dtype, device=like.device))
        return buf

    @staticmethod
    def _stage(buf: _Buffer, tensors: Sequence[torch.Tensor], numel: int) -> None:
        if numel:
            torch.cat([t.reshape(-1) for t in tensors], out=buf.tensor[:numel])

    @staticmethod
    def _views(entry: _Entry, role: str) -> List[torch.Tensor]:
        layout = getattr(entry, role)
        return _views(entry.bufs[role].tensor, layout) if layout[2] else []

    # -------------------------------------------------------------------- run
    def run(
        self,
        key: Hashable,
        body: Body,
        prepare: Prepare,
        live: Sequence[torch.Tensor],
        fixed: Sequence[torch.Tensor] = (),
        fixed_token: Any = None,
    ) -> Tuple[List[torch.Tensor], Any]:
        """``body``'s outputs for inputs ``fixed`` + ``live`` of structure
        ``key`` (views of one fresh copy of the output buffer), and
        ``prepare``'s ``meta``."""
        if not live:
            raise ValueError("a graph needs at least one live input")
        like = live[0]
        entry = self._entries.get(key)
        if entry is None:
            out_shapes, meta, keep = prepare()
            entry = _Entry(_layout(t.shape for t in fixed), _layout(t.shape for t in live), _layout(out_shapes),
                           meta, keep)
            self._insert(key, entry)
        else:
            self._entries.move_to_end(key)
        if not entry.bufs:
            entry.bufs = {role: self._buffer(role, getattr(entry, role)[2], like)
                          for role in ("fixed", "live", "out")}
        fb = entry.bufs["fixed"]
        if fixed and (fixed_token is None or fixed_token is not fb.token):
            self._stage(fb, fixed, entry.fixed[2])
            fb.token = fixed_token
        self._stage(entry.bufs["live"], live, entry.live[2])
        out = entry.bufs["out"].tensor
        if not entry.captured:
            if like.device.type == "cuda":
                self._capture(entry, body, like, out)
            entry.captured = True
            self.captures += 1
        if entry.graph is not None:
            entry.graph.replay()
            kernels.count_replay(entry.tally)
        else:
            self._write_out(entry, body(self._views(entry, "fixed"), self._views(entry, "live"), entry.keep), out)
        self.replays += 1
        n = entry.out[2]
        flat = out[:n].clone() if n else like.new_empty(0)
        return _views(flat, entry.out), entry.meta

    @staticmethod
    def _write_out(entry: _Entry, outs, out: torch.Tensor) -> None:
        """The outputs, checked against the prepared shapes, into ``out``."""
        outs = list(outs)
        if _layout(o.shape for o in outs) != entry.out:
            raise RuntimeError(f"outputs {[tuple(o.shape) for o in outs]} differ from the prepared {entry.out[0]}")
        if entry.out[2]:
            torch.cat([o.reshape(-1) for o in outs], out=out[:entry.out[2]])

    def _capture(self, entry: _Entry, body: Body, like: torch.Tensor, out: torch.Tensor) -> None:
        """Capture ``body`` on the staged inputs into ``entry.graph``."""
        dev = like.device
        if self._stream is None:
            self._start_pool(dev)
        fixed_v, live_v = self._views(entry, "fixed"), self._views(entry, "live")
        s, cur = self._stream, torch.cuda.current_stream(dev)
        s.wait_stream(cur)
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection during the capture: freeing another
        # graph (an engine that became garbage) while a stream captures
        # invalidates the capture
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(s), kernels.recording() as tally:
                graph.capture_begin(self._pool)
                try:
                    self._write_out(entry, body(fixed_v, live_v, entry.keep), out)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was already invalidated; report the cause
                    raise
                t1 = time.perf_counter()
                graph.capture_end()
        finally:
            if gc_was_enabled:
                gc.enable()
        cur.wait_stream(s)
        t2 = time.perf_counter()
        self.capture_seconds += t2 - t0
        self.instantiate_seconds += t2 - t1
        self.pool_bytes += max(0, torch.cuda.memory_reserved(dev) - reserved)
        entry.graph, entry.tally = graph, dict(tally)

    def _start_pool(self, dev: torch.device) -> None:
        """The side stream and the shared pool.  A pool whose graphs have
        all been freed cannot take a new capture, so a one-node graph holds
        it for the cache's life.  A GEMM on the side stream first sets up
        cuBLAS's workspace for that stream outside any capture."""
        self._stream = torch.cuda.Stream(dev)
        self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(dev)
        flag = torch.zeros(1, device=dev)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            for dtype in (torch.float64, torch.float32):
                torch.ones((8, 8), dtype=dtype, device=dev) @ torch.ones((8, 8), dtype=dtype, device=dev)
            self._anchor = torch.cuda.CUDAGraph()
            self._anchor.capture_begin(self._pool)
            flag.zero_()
            self._anchor.capture_end()
        cur.wait_stream(self._stream)
        self._anchor_flag = flag

    def _insert(self, key, entry: _Entry) -> None:
        self._entries[key] = entry
        while len(self._entries) > self.max_graphs:
            self._entries.popitem(last=False)
            self.evictions += 1

    # --------------------------------------------------------------- reports
    def _buffer_bytes(self) -> int:
        live = {id(b): b.tensor for b in self._buffers.values()}
        for e in self._entries.values():
            live.update((id(b), b.tensor) for b in e.bufs.values())
        return sum(t.numel() * t.element_size() for t in live.values())

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def stats(self) -> Dict[str, int]:
        return {
            "graph_captures": self.captures,
            "graph_replays": self.replays,
            "graphs": len(self._entries),
            "evictions": self.evictions,
            "buffer_growths": self.buffer_growths,
            "buffer_bytes": self._buffer_bytes(),
            "pool_bytes": self.pool_bytes,
            "capture_seconds": self.capture_seconds,
            "instantiate_seconds": self.instantiate_seconds,
        }
