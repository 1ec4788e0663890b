"""CUDA graphs of a step cut into segments, over buffers at fixed addresses.

JAX compiles a whole per-frame step into one device program whose
data-dependent branches are ``lax.cond``s. The port's counterpart cuts the
step at its branch points into segments, one variant per branch taken, and
runs each variant as a ``torch.cuda.CUDAGraph``:

- ``Slab``: one device buffer that holds every tensor of a pytree (nested
  tuples, NamedTuples, dicts, tensors, ``None``) at a fixed address, as
  views. A segment reads its inputs from slabs and copies its results into
  a slab, so a replayed graph finds its inputs and leaves its outputs where
  the capture saw them. Two slabs of one layout copy into each other with
  one ``copy_``.
- ``Graphs``: the variants by key. A variant's first use runs it eagerly on
  the capture stream under ``torch.cuda.set_sync_debug_mode("error")`` (so a
  hidden host sync raises; this run is also the warm-up that builds kernels
  and initializes the libraries' handles and workspaces) and then captures
  it; later uses replay the graph. Each variant gets its own memory pool
  (the variants replay in a data-dependent order, so they may not share
  one). A capture or replay that fails raises ``GraphError``: nothing falls
  back to running eagerly.

- ``compile_function``: the counterpart of ``jax.jit`` for a function
  with fixed shapes and no host branch (a window solver, the pyramid
  build, a KLT call): its arguments go into a slab, one ``Graphs`` variant
  per argument layout.

Counters kept in Python (the ``launches`` attributes of the kernel
wrappers, the collective counts of ``parallel.mesh.Mesh.counts``) do not
run on a replay. A capture records how far it moved each counter, puts the
counters back (the capture launched nothing) and every replay advances
them by that amount.

While the tracer is on (profiling), ``run`` records a ``graph.replay``
span over ``CUDAGraph.replay()`` (the host's ``cudaGraphLaunch``) and a
``graph.capture`` span over a variant's first use (its eager run and
capture), each with the variant's key.

On the CPU, which a caller asks for explicitly, a variant runs eagerly on
every use over the same slabs: the same data path without capture (its
``graph.replay`` span covers the eager run).
"""

from __future__ import annotations

import time

import torch

from .. import profiling

ALIGN = 256   # bytes: every view of a slab starts on such a boundary


class GraphError(RuntimeError):
    """A CUDA graph failed to capture or replay."""


def leaves(tree):
    """The tensors of a pytree, depth first (dicts in their key order)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    raise TypeError(f"not a tensor pytree leaf: {type(tree).__name__}")


def rebuild(tree, it):
    """`tree` with its tensors replaced, in order, by the iterator's."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: rebuild(v, it) for k, v in tree.items()}
    vals = [rebuild(v, it) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


class Slab:
    """The tensors of `template` (a pytree) as views of one uint8 buffer on
    `device`: `tree` is the template's structure over the views. Holds no
    values until loaded."""

    def __init__(self, template, device):
        self.template = template
        self.specs, off = [], 0
        for t in leaves(template):
            self.specs.append((off, t.dtype, tuple(t.shape)))
            off += -(-t.numel() * t.element_size() // ALIGN) * ALIGN
        self.nbytes = off
        self.buf = torch.empty(off, dtype=torch.uint8, device=device)
        self.views = [
            self.buf[o:o + _numel(sh) * dt.itemsize].view(dt).view(sh)
            for o, dt, sh in self.specs]
        self.tree = rebuild(template, iter(self.views))

    def fresh_tree(self):
        """The views in a newly built pytree (a new object each call)."""
        return rebuild(self.template, iter(self.views))

    def load(self, tree):
        """Copy the tensors of `tree` (the template's structure, shapes,
        dtypes and device) into place; raises ValueError otherwise."""
        ts = leaves(tree)
        if len(ts) != len(self.views):
            raise ValueError(f"{len(ts)} tensors, the slab holds "
                             f"{len(self.views)}")
        for i, (v, t) in enumerate(zip(self.views, ts)):
            if t.shape != v.shape or t.dtype != v.dtype \
                    or t.device != v.device:
                raise ValueError(
                    f"tensor {i}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                    f"the slab holds {tuple(v.shape)} {v.dtype} on "
                    f"{v.device}")
            v.copy_(t)

    def same_prefix(self, other: "Slab") -> bool:
        """Whether this slab's layout is the start of `other`'s, so that
        ``self.buf.copy_(other.buf[:self.nbytes])`` copies every tensor."""
        return other.specs[:len(self.specs)] == self.specs


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _get(slot):
    o, k = slot
    return o[k] if isinstance(o, dict) else getattr(o, k)


def _set(slot, value):
    o, k = slot
    if isinstance(o, dict):
        o[k] = value
    else:
        setattr(o, k, value)


class Graphs:
    """The captured variants of a step's segments, by key, on `device`.

    counters: Python counters to carry over replays (see the module
    docstring), each an (object, attribute) pair or a dict (every item of
    it)."""

    def __init__(self, device, counters=()):
        self.device = torch.device(device)
        self.counters = tuple(counters)
        self.graphs = {}        # key -> (CUDAGraph, [(slot, delta)])
        self.capture_ms = {}    # key -> ms of the first run and the capture
        self.uses = {}          # key -> runs (the first one and replays)
        self.replays = 0
        self._stream = None

    def _slots(self):
        """(container, key) of every counter, a dict's items one by one."""
        slots = []
        for c in self.counters:
            slots += [(c, k) for k in c] if isinstance(c, dict) else [c]
        return slots

    def run(self, key, fn):
        """Run variant `key` (`fn()`, which reads and writes slabs): replay
        its graph, or on its first use run it eagerly and capture it."""
        self.uses[key] = self.uses.get(key, 0) + 1
        if self.device.type != "cuda":
            with profiling.span("graph.replay", key=key):
                fn()
            return
        entry = self.graphs.get(key)
        if entry is None:
            with profiling.span("graph.capture", key=key):
                self._first_use(key, fn)
            return
        graph, delta = entry
        try:
            with profiling.span("graph.replay", key=key):
                graph.replay()
        except Exception as e:
            raise GraphError(f"replay of {key!r} failed: {e}") from e
        for slot, d in delta:
            _set(slot, _get(slot) + d)
        self.replays += 1

    def _first_use(self, key, fn):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side, cur = self._stream, torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        side.wait_stream(cur)
        prev = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        cur.wait_stream(side)
        slots = self._slots()
        before = [_get(slot) for slot in slots]
        graph = torch.cuda.CUDAGraph()
        # The capture itself fails on any host sync; the debug mode is off
        # for torch.cuda.graph's own synchronize and cache release.
        torch.cuda.set_sync_debug_mode("default")
        try:
            # thread_local: another thread of the program (a prefetching
            # reader that pins memory) may keep calling CUDA meanwhile.
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                fn()
        except Exception as e:
            raise GraphError(f"capture of {key!r} failed: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            delta = [(slot, _get(slot) - b) for slot, b in zip(slots, before)
                     if _get(slot) != b]
            for slot, b in zip(slots, before):
                _set(slot, b)
        self.graphs[key] = (graph, delta)
        self.capture_ms[key] = (time.perf_counter() - t0) * 1e3


def _layout(tree):
    """A hashable description of a pytree: its structure and its tensors'
    dtypes, shapes and devices."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return (tree.dtype, tuple(tree.shape), tree.device)
    if isinstance(tree, dict):
        return (dict, tuple((k, _layout(v)) for k, v in tree.items()))
    if isinstance(tree, tuple):
        return (type(tree), tuple(_layout(v) for v in tree))
    raise TypeError(f"not a tensor pytree leaf: {type(tree).__name__}")


class CompiledFunction:
    """`fn` over fixed buffers, one CUDA graph per argument layout
    (compile_function builds it; see there). `graphs` holds the variants,
    keyed 0, 1, ... in the order their layouts first came."""

    def __init__(self, fn, device, counters=()):
        self.fn = fn
        self.graphs = Graphs(device, counters)
        self._io = {}    # layout -> [variant key, input Slab, output Slab]

    def __call__(self, *args):
        layout = _layout(args)
        if layout not in self._io:
            self._io[layout] = [len(self._io), Slab(args, self.graphs.device),
                                None]
        io = self._io[layout]
        key, inp = io[0], io[1]
        inp.load(args)

        def run():
            res = self.fn(*inp.tree)
            if io[2] is None:
                io[2] = Slab(res, self.graphs.device)
            io[2].load(res)
        self.graphs.run(key, run)
        return io[2].tree


def compile_function(fn, device, counters=()) -> CompiledFunction:
    """`fn` compiled: the port's ``jax.jit`` for a function with fixed
    shapes and no host branch (a window solver, the pyramid build, a KLT
    call). Called with the arguments of `fn`, pytrees of tensors on
    `device` (bind every other argument, a config say, into `fn` first);
    they are copied into a fixed buffer, one per argument layout (structure,
    dtypes, shapes), and each layout's first call runs `fn` eagerly and
    captures it as a CUDA graph (utils.graphs.Graphs: a hidden host sync or
    a failed capture raises GraphError), later calls replay it. The result,
    a pytree of tensors, comes back in that layout's output buffer, which
    the next call of the same layout overwrites: copy what must live
    longer. `counters` as in Graphs. On the CPU `fn` runs eagerly on every
    call, over the same buffers."""
    return CompiledFunction(fn, device, counters)
