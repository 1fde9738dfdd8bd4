"""CUDA graphs: the port's counterpart of the JAX package's ``jax.jit``.

:func:`graphed` wraps an entry point. Called on the CPU, it is the plain
function. On the card it keeps one program per input signature: the
shapes, dtypes, strides and devices of the tensor arguments, the identity
of every other object (a model, an optimizer), the value of the rest
(numbers, strings, frozen configs) and the autograd mode, as ``jit``
compiles once per shape and static argument. For one signature:

* the first call runs the function eagerly and returns its result (the
  warm-up: kernel libraries load, cuBLAS makes its workspaces, an
  optimizer its state);
* the second captures it into CUDA graphs, then replays them;
* every later call copies its tensors into the program's input buffers,
  replays, and returns copies of the program's outputs.

So every call makes one execution's launches. A program is one graph, or
a run of graphs separated by host loops: where the JAX package runs a
``lax.while_loop`` that stops on a device value, the function calls
:func:`loop`, whose body is captured once and replayed until the flag it
returns is set (the host reads the flag once per replay).

What the function reads must be an argument or live at a fixed address (a
model's parameters, an optimizer's state; ``load_state_dict`` copies into
them). It must not write into its tensor arguments, nor synchronise with
the host (``.item()``, ``bool(t)``, a copy between host and device): the
capture then raises, and the wrapper raises with it. A tensor argument on
the CPU is moved to the card first. Outputs that are not tensors are those
of the capture.

Random numbers: each ``torch.Generator`` argument (on the card) is replaced
in the capture by the program's own generator, registered with each of
its graphs. Before the replays that generator takes the caller's state,
after them the caller's takes its state, so a call draws what an eager call
with the caller's generator draws and leaves that generator where the
eager call would.

Launch counts: ``ops.kernels.count`` during a capture goes to the graph's
tally, and each replay adds the tally (``kernels.replayed``).

A model sliced for tensor parallelism (``parallel.tensor.shard_tp``),
split over ``sp`` (``parallel.sequence.shard_sp``) or staged over ``pp``
(``parallel.pipeline.shard_pp``) runs every call eagerly: a gloo group's
collectives run on the host and cannot be captured
(``cudaErrorStreamCaptureUnsupported``), and a replay of NCCL collectives
at world > 1 cannot be held against eager calls on a one-card machine
(ROADMAP.md queue 1 item 2).

First calls and captures run under one lock, on the caller's current
stream, or on a side stream of the device when the caller is on the
default stream (which cannot capture); the capture mode is
``thread_local``. A device-wide synchronisation from another thread still
breaks a capture, so the serving engine captures both of its phases before
it serves. A program is dropped when an object of its signature (the
model, the optimizer) is garbage-collected.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import inspect
import threading
import warnings
import weakref

import torch

from videotgb_torch.ops import kernels
from videotgb_torch.parallel.pipeline import is_staged
from videotgb_torch.parallel.sequence import is_split
from videotgb_torch.parallel.sharding import all_ranks
from videotgb_torch.parallel.tensor import is_sliced

_LOCK = threading.RLock()
_STATE = threading.local()  # .depth: graphed calls open; .builder: capture
_SIDE: dict[int, torch.cuda.Stream] = {}
_VALUES = (bool, int, float, complex, str, bytes, type(None), torch.dtype,
           torch.device)
_SEEN = object()  # a signature whose first, eager call has run
_WRAPPERS: "weakref.WeakSet[Graphed]" = weakref.WeakSet()


# ------------------------------------------------------------ arguments
def _flatten(x, leaves: list):
    """The structure of nested dicts, lists and tuples, its leaves appended
    to ``leaves``."""
    if isinstance(x, dict):
        return ("dict", tuple(x), tuple(_flatten(v, leaves)
                                        for v in x.values()))
    if type(x) in (list, tuple):
        return (type(x).__name__, tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return None


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    if spec[0] == "dict":
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    items = [_unflatten(s, leaves) for s in spec[1]]
    return items if spec[0] == "list" else tuple(items)


def _by_value(x) -> bool:
    return isinstance(x, _VALUES) or (
        dataclasses.is_dataclass(x) and not isinstance(x, type)
        and x.__dataclass_params__.frozen)


def _leaf_key(x):
    if torch.is_tensor(x):
        return ("tensor", tuple(x.shape), x.dtype, x.device, x.stride(),
                x.requires_grad)
    if isinstance(x, torch.Generator):
        return ("generator", x.device)
    if _by_value(x):
        return ("value", x)
    return ("object", id(x))


def _device_of(leaves):
    """The call's device: a module's, else the first tensor's."""
    for x in leaves:
        if isinstance(x, torch.nn.Module):
            for t in x.parameters():
                return t.device
    for x in leaves:
        if torch.is_tensor(x):
            return x.device
    return None


# --------------------------------------------------------------- streams
@contextlib.contextmanager
def _capture_stream(device):
    """The caller's stream, or (on the default stream, which cannot
    capture) the device's side stream, ordered after and before the
    caller's work."""
    current = torch.cuda.current_stream(device)
    if current != torch.cuda.default_stream(device):
        yield current
        return
    side = _SIDE.get(device.index)
    if side is None:
        side = _SIDE[device.index] = torch.cuda.Stream(device)
    side.wait_stream(current)
    try:
        with torch.cuda.stream(side):
            yield side
    finally:
        current.wait_stream(side)


@contextlib.contextmanager
def _nested():
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        yield
    finally:
        _STATE.depth -= 1


# ---------------------------------------------------------------- graphs
class _Graph:
    """One captured graph and the kernel launches it replays."""

    def __init__(self, graph, tally):
        self.graph = graph
        self.tally = tally

    def replay(self):
        self.graph.replay()
        kernels.replayed(self.tally)


class _Builder:
    """The graphs of one program, captured in turn on one stream into one
    memory pool while the function runs."""

    def __init__(self, stream, generators):
        self.stream = stream
        self.generators = generators
        self.pool = torch.cuda.graph_pool_handle()
        self.steps = []  # (_Graph, None) or (_Graph, (flag, max_iters))
        self.open = None

    def begin(self):
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        tally = collections.Counter()
        kernels.begin_capture(self.stream.cuda_stream, tally)
        try:
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
        except BaseException:
            kernels.end_capture(self.stream.cuda_stream)
            raise
        self.open = (graph, tally)

    def end(self, loop=None):
        graph, tally = self.open
        self.open = None
        try:
            with warnings.catch_warnings():
                # the graph after a program's last loop may hold no kernel
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                graph.capture_end()
        finally:
            kernels.end_capture(self.stream.cuda_stream)
        self.steps.append((_Graph(graph, tally), loop))

    def abort(self):
        """After a failure inside the capture: end the open capture (CUDA
        reports it invalidated), then capture an empty graph with the same
        generators, whose capture epilogue takes them (and the default
        generator) out of capture mode."""
        if self.open is not None:
            graph, _ = self.open
            self.open = None
            try:
                graph.capture_end()
            except Exception:  # noqa: BLE001 - the failure being raised
                pass  # is the one that matters
            finally:
                kernels.end_capture(self.stream.cuda_stream)
        reset = torch.cuda.CUDAGraph()
        for gen in self.generators:
            reset.register_generator_state(gen)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            reset.capture_begin(capture_error_mode="thread_local")
            reset.capture_end()


def loop(body, max_iters: int) -> None:
    """Run ``body()`` up to ``max_iters`` times, stopping after a call
    whose returned 0-dim bool tensor is True (a host read each time). In a
    capture, ``body`` is captured once into a graph of its own that each
    replay of the program runs this way; ``body`` must then update its
    state in place. Eagerly, under a lockstep data-parallel split, the loop
    stops when every rank's flag is set (``parallel.sharding.all_ranks``):
    a sharded model gathers its parameters at every step, on every rank."""
    builder = getattr(_STATE, "builder", None)
    if builder is None:
        for _ in range(max_iters):
            if bool(all_ranks(body())):
                break
        return
    builder.end()
    builder.begin()
    flag = body()
    builder.end(loop=(flag, max_iters))
    builder.begin()


class _Program:
    """A captured signature: input buffers, the program's generators, the
    graphs and the output buffers."""

    def __init__(self, buffers, generators, steps, out_spec, out_leaves):
        self.buffers = buffers  # one per tensor leaf, in order
        self.generators = generators  # caller leaf index -> own generator
        self.steps = steps
        self.out_spec = out_spec
        self.out_leaves = out_leaves
        self.lock = threading.Lock()

    def run(self):
        for graph, loop_of in self.steps:
            if loop_of is None:
                graph.replay()
                continue
            flag, max_iters = loop_of
            for _ in range(max_iters):
                graph.replay()
                if bool(flag):
                    break

    def __call__(self, leaves):
        with self.lock:
            tensors = (x for x in leaves if torch.is_tensor(x))
            for buf, x in zip(self.buffers, tensors):
                if x is not buf:
                    buf.copy_(x)
            for i, own in self.generators.items():
                own.set_state(leaves[i].get_state())
            self.run()
            for i, own in self.generators.items():
                leaves[i].set_state(own.get_state())
            out = [x.clone() if torch.is_tensor(x) else x
                   for x in self.out_leaves]
        return _unflatten(self.out_spec, iter(out))


# --------------------------------------------------------------- wrapper
def _forget(wrapper_ref, owner: int) -> None:
    wrapper = wrapper_ref()
    if wrapper is not None:
        wrapper._forget(owner)


@contextlib.contextmanager
def eager():
    """Within the block every graphed call runs its eager function: a
    model under FSDP2 gathers its parameters from the host at every unit,
    which no program can replay."""
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        yield
    finally:
        _STATE.depth -= 1


def invalidate(obj) -> None:
    """Drop every program keyed by ``obj``: its tensors moved (an
    optimizer's ``load_state_dict`` makes new state tensors). The next call
    runs eagerly again, the one after captures."""
    for wrapper in list(_WRAPPERS):
        wrapper._forget(id(obj))


def graphed(fn=None, *, eager_when=None):
    """``fn`` run as a CUDA-graph program per signature on the card,
    plainly on the CPU (see the module's docstring); a decorator, bare or
    with ``eager_when(arguments)`` (the bound arguments by name), which
    names the calls that stay eager (beam search, whose loop the host
    steers every step). The result's ``.eager`` is ``fn`` itself, the plain
    reference."""
    if fn is None:
        return lambda f: Graphed(f, eager_when)
    return Graphed(fn, eager_when)


class Graphed:
    """The wrapper :func:`graphed` returns."""

    def __init__(self, fn, eager_when=None):
        functools.update_wrapper(self, fn)
        self.eager = fn
        self._eager_when = eager_when
        self._signature = inspect.signature(fn) if eager_when else None
        self._programs: dict = {}
        self._owners: dict[int, set] = {}  # id of an object leaf -> keys
        self._lock = threading.Lock()
        _WRAPPERS.add(self)

    def __call__(self, *args, **kwargs):
        if getattr(_STATE, "depth", 0):  # inside another graphed call
            return self.eager(*args, **kwargs)
        if self._eager_when is not None and self._eager_when(
                self._signature.bind(*args, **kwargs).arguments):
            return self.eager(*args, **kwargs)
        leaves = []
        spec = _flatten((args, kwargs), leaves)
        if any(isinstance(x, torch.nn.Module)
               and (is_sliced(x) or is_split(x) or is_staged(x))
               for x in leaves):
            return self.eager(*args, **kwargs)
        device = _device_of(leaves)
        if device is None or device.type != "cuda":
            return self.eager(*args, **kwargs)
        leaves = [x.to(device) if torch.is_tensor(x) and x.device.type == "cpu"
                  else x for x in leaves]
        for x in leaves:
            if isinstance(x, torch.Generator) and x.device.type != "cuda":
                raise ValueError(f"{self.__name__}: a CPU generator cannot "
                                 "drive a CUDA graph; pass one on the card")
        key = (spec, tuple(_leaf_key(x) for x in leaves),
               torch.is_grad_enabled(), torch.is_inference_mode_enabled())
        program = self._programs.get(key)
        if program is None or program is _SEEN:
            with _LOCK:
                program = self._programs.get(key)
                if program is None:
                    self._remember(key, leaves, _SEEN)
                    args, kwargs = _unflatten(spec, iter(leaves))
                    with _capture_stream(device), _nested():
                        return self.eager(*args, **kwargs)
                if program is _SEEN:
                    program = self._capture(spec, leaves, device)
                    self._remember(key, leaves, program)
        return program(leaves)

    def programs(self) -> list:
        """The captured programs, one per signature captured so far (each
        one's ``steps``: (graph, None) or (graph, (flag, max_iters)) for a
        loop's body)."""
        with self._lock:
            return [p for p in self._programs.values()
                    if isinstance(p, _Program)]

    def _remember(self, key, leaves, entry):
        with self._lock:
            self._programs[key] = entry
            for x in leaves:
                if torch.is_tensor(x) or isinstance(x, torch.Generator) \
                        or _by_value(x):
                    continue
                keys = self._owners.get(id(x))
                if keys is None:
                    keys = self._owners[id(x)] = set()
                    try:  # the wrapper held weakly: a trainer's dies
                        weakref.finalize(x, _forget, weakref.ref(self), id(x))
                    except TypeError as e:
                        raise TypeError(
                            f"{self.__name__}: argument of type "
                            f"{type(x).__name__} is neither a value nor an "
                            "object a program can key by identity") from e
                keys.add(key)

    def _forget(self, owner: int):
        with self._lock:
            for key in self._owners.pop(owner, ()):
                self._programs.pop(key, None)

    def _capture(self, spec, leaves, device) -> _Program:
        for x in leaves:
            if torch.is_tensor(x) and x.requires_grad:
                raise ValueError(f"{self.__name__}: a graphed function's "
                                 "tensor arguments take no gradient")
        buffers, inputs, own, generators = [], [], {}, {}
        for i, x in enumerate(leaves):
            if torch.is_tensor(x):
                buf = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                          device=x.device)
                buffers.append(buf)
                inputs.append(buf)
            elif isinstance(x, torch.Generator):
                gen = own.get(id(x))
                if gen is None:
                    gen = own[id(x)] = torch.Generator(device=x.device)
                generators[i] = gen
                inputs.append(gen)
            else:
                inputs.append(x)
        args, kwargs = _unflatten(spec, iter(inputs))
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()  # the warm-up's cached blocks
        with _capture_stream(device) as stream, _nested():
            builder = _Builder(stream, list(own.values()))
            _STATE.builder = builder
            try:
                builder.begin()
                out = self.eager(*args, **kwargs)
                builder.end()
            except BaseException:
                builder.abort()
                raise
            finally:
                _STATE.builder = None
        out_leaves = []
        out_spec = _flatten(out, out_leaves)
        return _Program(buffers, generators, builder.steps, out_spec,
                        out_leaves)
