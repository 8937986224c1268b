"""Captured chunk programs: the port's counterpart of the reference's
``jax.jit`` programs: over ``lax.scan`` (lewton_tpu/parallel/batch.py:66-89,
183-229), the single-stream ``decode_frames`` (models/decoder.py:752) and
the dp mesh's ``shard_map`` (parallel/batch.py:246-265).

The reference compiles each chunk program once per shape and runs N chunks
in one device dispatch, to spread the host's per-dispatch cost over them.
PyTorch runs eagerly: one chunk of the i16 main path enqueues some 170
device activities from Python, and at the headline shape the host's
enqueue takes as long as the card's work. The PyTorch idiom for a program
compiled once and dispatched once is a CUDA graph, captured at the first
call and replayed on every later one: :class:`ChunkProgram`.

A program is a ``body(inputs, carry, outputs) -> new carry`` over static
buffers allocated before capture, outside the graph's memory pool: its
outputs, and the inputs (with the layout of the frames it was made for:
shapes, strides and dtypes) and the carry, which belong to the owner
(:class:`Programs`: one set per layout, shared by all of its programs). The
graph ends with a device copy of the new carry into the static carry, so
successive runs on one stream chain the carry with no host step, as
``lax.scan``'s carry does. A call copies the caller's inputs and carry into
the static ones, unless they are those same tensors (same data pointer,
shape, strides and dtype), runs, and returns the static outputs and carry.

**Lifetime** (the CUDA-graph contract; unlike XLA's, results are not
fresh). The outputs a call returns are the program's own: they hold their
values until the next run of that program. The carry it returns is the
owner's static carry of its layout: it holds its values until the next run
of *any* program of the same owner with that carry layout (a
``decode_chunks_scan`` of 16 chunks and a one-chunk ``decode_chunk_batch``
from the same carry layout in one :class:`Programs` share it). The same
holds for the static inputs, per input layout. Copy what must outlive
that.

**Keys.** :class:`Programs` keys the programs as the reference's jit
does. The batch programs (``parallel/batch.py``) take the setup's identity
(the program holds the setup, so the identity is not reused while it
lives), the static arguments (``with_i16``, ``compact_cap``), the frames'
signature and N, and the routing flags read while the program is made
(``USE_DCT4_SPLIT``, ``USE_FUSED_SYNTH_KERNEL``), which a captured graph
would otherwise keep. The single-stream programs
(``models.decoder.frames_program``, the counterpart of the reference's
jitted ``decode_frames``) take the setup's geometry in its place, as the
reference's jit does for its pytree ``CompiledSetup``: the static fields
(``CompiledSetup._static_names``) and the :func:`signature` of the table
leaves, with ``with_i16``, ``compact_cap``, the frames' signature and the
routing flags. Their setup tables are inputs: the owner keeps one static
copy of each table layout (:meth:`Programs.static_tables`), into which a
call copies the caller's setup's tables unless they are the ones it holds
already, so a fresh reader of a setup geometry the process has seen
replays the program it captured, and the tables move only when the setup
changes.

**Owners.** A batch caller owns its :class:`Programs` (``TransferSlots``,
the bench). The single-stream path has one owner per device for the whole
process (:func:`stream_programs`), the counterpart of jit's process-wide
cache: every ``StreamDecoder`` on that device, and so every
``OggStreamReader`` of the torch backend, the async reader and the
examples, runs its chunks through it. Its carry of a layout is shared by
every stream decoded there, so a ``StreamDecoder`` copies the carry a run
returns into its own tensors before any other run of that owner (the
carry rule; see the lifetime above). An owner's programs run on one
thread.

**Collectives.** A mesh's chunk at tp > 1 all-reduces the IMDCT's partial
products over the tp group inside the chunk (the reference's ``psum``
inside its jitted ``shard_map``), and gloo's collectives cannot be
captured. :class:`SegmentedProgram` captures the work on either side of
each collective as a graph of its own and runs the collective eagerly
between their replays, in stream order, on a static buffer. (NCCL at one
rank a card could put the all-reduce inside one graph; that waits for a
machine with two or more cards.)

**No fallback.** On a card, a capture that fails raises
:class:`CaptureError` naming the op that broke it; nothing runs eagerly in
its place. A program runs its body eagerly, on the same static buffers, in
these cases only: on the CPU (which the caller asks for, as the tests do);
inside :func:`eager` (the counterpart of ``jax.disable_jit()``); and
whenever a kernel wrapper is not the package's own
(``launch.kernels_in_use``).

Where capture is likely to break, and what this module does about it:

- *Host syncs.* ``.item()``, a host scalar made a CUDA tensor and a
  pageable host-to-device copy synchronise, and capture refuses them. The
  first call runs the body eagerly on the side stream that captures it
  (:meth:`ChunkProgram._warm_up`), so every table that a function makes
  once per process (``ops.imdct.split_tables``), the kernels' shared-memory
  attributes (``cudaFuncSetAttribute`` in ``csrc/*.cu``), the library
  loads and cuBLAS's workspace for that stream exist before capture.
- *Kernel streams.* The C entries launch on
  ``torch.cuda.current_stream().cuda_stream``, which is the capture stream
  inside :func:`torch.cuda.graph`; they do not synchronise.
- *Launch counters.* A replay does not pass through the wrappers, so
  :meth:`ChunkProgram._capture` records each counter's change during the
  capture and puts the counters back (a capture runs nothing), and every
  replay adds that change to ``launch.REPLAYED``, apart from the wrappers'
  own counters.
- *Swapped wrappers.* ``launch.plain_kernels()`` and ``held_kernels()``
  swap the wrappers the decoder calls. A graph captured with the kernels
  in it never replays there: programs run eagerly while any wrapper is
  not the package's own (``launch.kernels_in_use``), so the plain path
  launches nothing and every held launch is checked.
- *cuBLAS.* The package pins fp32 GEMMs with TF32 off at import; the
  capture raises if that setting has changed, since a graph keeps the math
  mode it was captured with.
"""

from __future__ import annotations

import contextlib
import time
import traceback
import weakref

import torch

from . import launch

__all__ = ["ChunkProgram", "SegmentedProgram", "Programs", "CaptureError",
           "eager", "signature", "stream_programs"]

_EAGER_DEPTH = 0
#: the single-stream owner of each device (:func:`stream_programs`)
_STREAM_OWNERS: dict = {}


@contextlib.contextmanager
def eager():
    """Every program runs its eager body for the block, on its static
    buffers (the counterpart of ``jax.disable_jit()``)."""
    global _EAGER_DEPTH
    _EAGER_DEPTH += 1
    try:
        yield
    finally:
        _EAGER_DEPTH -= 1


class CaptureError(RuntimeError):
    """A chunk program failed to capture on a card."""


def _leaves(tree) -> list:
    """The tensors of a dict or tuple whose values are tensors or tuples of
    tensors (frames with ``f1_brackets``), in order."""
    out = []
    for v in (tree.values() if isinstance(tree, dict) else tree):
        out.extend(v if isinstance(v, (tuple, list)) else (v,))
    return out


def signature(tree) -> tuple:
    """(shape, strides, dtype) of every tensor of ``tree``: a program made
    for one signature takes inputs of that signature only."""
    return tuple((tuple(t.shape), t.stride(), t.dtype) for t in _leaves(tree))


def _static_like(tree, device):
    """Empty tensors on ``device`` with the layout of ``tree``'s (shapes,
    strides, dtypes; a broadcast axis stays a broadcast axis), in the same
    dict/tuple structure."""
    def one(t):
        return torch.empty_strided(tuple(t.shape), t.stride(), dtype=t.dtype,
                                   device=device)

    def sub(v):
        return tuple(map(one, v)) if isinstance(v, (tuple, list)) else one(v)
    if isinstance(tree, dict):
        return {k: sub(v) for k, v in tree.items()}
    return tuple(sub(v) for v in tree)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.device == b.device and a.dtype == b.dtype
            and a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _load(static, given) -> None:
    """Copy ``given`` into the static tensors, leaf by leaf, skipping a
    leaf that is the static tensor itself. A broadcast axis (stride 0) is
    copied once: the given leaf has the same strides (the key holds them),
    so its values along that axis are one."""
    st, gv = _leaves(static), _leaves(given)
    if len(st) != len(gv):
        raise ValueError(f"a program of {len(st)} tensors was given {len(gv)}")
    for dst, src in zip(st, gv):
        if _same(dst, src):
            continue
        if 0 in dst.stride():
            idx = tuple(0 if s == 0 else slice(None) for s in dst.stride())
            dst, src = dst[idx], src[idx]
        dst.copy_(src, non_blocking=True)


def _pool_bytes(pool) -> int:
    """Bytes of the device segments that belong to graph pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _culprit(exc: BaseException) -> str:
    """file:line and source of the innermost frame of ``exc`` outside this
    module: the op that broke a capture."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f.filename != __file__]
    if not frames:
        return "unknown"
    f = frames[-1]
    return f"{f.filename}:{f.lineno}: {f.line}"


class Programs:
    """One owner's chunk programs (``key -> ChunkProgram``), the memory
    pool and side stream their captures share, and the owner's static
    carry and inputs for each layout, shared by its programs. Its programs
    run one at a time on the owner's stream, which is what makes one pool
    and one set of static inputs and carry a layout safe to share: nothing
    of one program is live in the pool while another runs, and each run
    loads its inputs and carry just before it."""

    def __init__(self):
        self.programs: dict = {}
        self._carries: dict = {}
        self._inputs: dict = {}
        #: id of a static table set -> weak reference to the source whose
        #: tables it holds (:meth:`static_tables`)
        self._sources: dict = {}
        self.pool = None
        self._stream = None

    def get(self, key, make):
        """The program of ``key``, made by ``make()`` at its first use."""
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = make()
        return prog

    def static_carry(self, carry) -> tuple:
        """The owner's static carry of ``carry``'s layout (allocated at its
        first use, contiguous)."""
        sig = tuple((tuple(c.shape), c.dtype) for c in carry)
        st = self._carries.get(sig)
        if st is None:
            st = self._carries[sig] = tuple(
                torch.empty(c.shape, dtype=c.dtype, device=c.device)
                for c in carry)
        return st

    def static_inputs(self, inputs, device):
        """The owner's static inputs of ``inputs``' structure and layout on
        ``device`` (allocated at their first use, :func:`_static_like`)."""
        key = (tuple(inputs) if isinstance(inputs, dict) else len(inputs),
               signature(inputs), str(device))
        st = self._inputs.get(key)
        if st is None:
            st = self._inputs[key] = _static_like(inputs, device)
        return st

    def static_tables(self, tables: dict, source) -> dict:
        """The owner's static copy of ``tables`` (a dict of tensors: a
        setup's tables; one copy per layout, :meth:`static_inputs`),
        holding ``source``'s: copied in unless it holds that source's
        already. ``source`` (the setup) is held weakly, so a freed source's
        id, reused by another, never passes for it; its tables must not be
        written after it is first given."""
        st = self.static_inputs(tables, next(iter(tables.values())).device)
        ref = self._sources.get(id(st))
        if ref is None or ref() is not source:
            _load(st, tables)
            self._sources[id(st)] = weakref.ref(source)
        return st

    def side_stream(self, device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def pool_mb(self) -> float | None:
        """MB of the shared pool's segments (None before any capture)."""
        return None if self.pool is None else _pool_bytes(self.pool) / 2**20

    def stats(self) -> dict:
        """Programs made and captured; their replays and the host seconds
        of those calls; the host seconds of their first calls on a card
        (warm-up and capture) and of the captures alone; the pool's MB."""
        progs = list(self.programs.values())
        return {"programs": len(progs),
                "captured": sum(p.graph is not None for p in progs),
                "replays": sum(p.replays for p in progs),
                "replay_s": sum(p.replay_s for p in progs),
                "first_use_s": sum(p.first_s or 0.0 for p in progs),
                "capture_s": sum(p.capture_s or 0.0 for p in progs),
                "pool_mb": self.pool_mb()}


def stream_programs(device) -> Programs:
    """The single-stream owner of ``device`` (a card without an index is
    the current one), made at its first use and kept for the process: the
    programs of every ``StreamDecoder`` there (see Owners above)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    owner = _STREAM_OWNERS.get(dev)
    if owner is None:
        owner = _STREAM_OWNERS[dev] = Programs()
    return owner


class ChunkProgram:
    """One captured CUDA graph of one chunk program.

    ``body(inputs, carry, outputs)`` decodes from the static ``inputs``
    and carry (the owner's, of ``inputs_like``'s and ``carry_like``'s
    layouts), writes ``outputs`` in place and returns the new carry.
    Calling the program copies the caller's inputs and carry in (see
    :func:`_load`), runs the body (its first call on a card, eagerly on the
    owner's side stream, then captures it; every later call replays the
    graph) and returns ``(outputs, carry)``: the static buffers, the
    outputs valid until this program's next run, the carry until the next
    run of any program of the owner with its layout."""

    def __init__(self, owner: Programs, body, inputs_like, carry_like,
                 outputs: tuple, key=None):
        self.owner = owner
        self.body = body
        self.key = key
        self.device = outputs[0].device
        self.inputs = owner.static_inputs(inputs_like, self.device)
        self.carry = owner.static_carry(carry_like)
        self.outputs = outputs
        #: the body as (captured, fn) steps: one segment here;
        #: :class:`SegmentedProgram`'s collectives are steps not captured
        self.steps = [(True, self._body)]
        #: per step, after the capture: (its graph, the launch counters'
        #: change during its capture), None for a step not captured
        self.graph: list | None = None
        #: counter deltas of one run (launch.COUNTERS' names), from the
        #: capture
        self.launches: dict = {}
        self.replays = 0
        self.replay_s = 0.0  # host seconds of the replaying calls
        self.first_s: float | None = None  # warm-up and capture
        self.capture_s: float | None = None
        self.pool_mb: float | None = None  # the pool's growth at capture

    def _body(self) -> None:
        new = self.body(self.inputs, self.carry, self.outputs)
        for st, c in zip(self.carry, new):
            st.copy_(c)

    def _run(self) -> None:
        for _, fn in self.steps:
            fn()

    def graphed(self) -> bool:
        """Whether this call replays (or captures): on a card, outside
        :func:`eager`, with the kernels' own wrappers."""
        return (self.device.type == "cuda" and not _EAGER_DEPTH
                and launch.kernels_in_use())

    def __call__(self, inputs, carry):
        t0 = time.perf_counter()
        _load(self.inputs, inputs)
        _load(self.carry, carry)
        if not self.graphed():
            self._run()
        elif self.graph is None:
            side = self._warm_up()
            t1 = time.perf_counter()
            self._capture(side)
            self.capture_s = time.perf_counter() - t1
            self.first_s = time.perf_counter() - t0
        else:
            self._replay()
            self.replays += 1
            self.replay_s += time.perf_counter() - t0
        return self.outputs, self.carry

    def _warm_up(self) -> torch.cuda.Stream:
        """The first run, eagerly on the owner's side stream (the stream
        the capture will use): its results are this call's, and whatever a
        function makes once, or cuBLAS per stream, exists before capture."""
        cur = torch.cuda.current_stream(self.device)
        side = self.owner.side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._run()
        cur.wait_stream(side)
        return side

    def _capture(self, side) -> None:
        """Capture each captured step as a graph of its own; the launches
        of one run are the sum of theirs."""
        pool0 = 0 if self.owner.pool is None else _pool_bytes(self.owner.pool)
        segs = [self._capture_fn(fn, side) if captured else None
                for captured, fn in self.steps]
        self.launches = {}
        for seg in filter(None, segs):
            for k, n in seg[1].items():
                self.launches[k] = self.launches.get(k, 0) + n
        self.graph = segs
        self.pool_mb = (_pool_bytes(self.owner.pool) - pool0) / 2**20

    def _replay(self) -> None:
        for (_, fn), seg in zip(self.steps, self.graph):
            if seg is None:
                fn()
            else:
                seg[0].replay()
                launch._add_replayed(seg[1])

    def _capture_fn(self, fn, side) -> tuple:
        """Capture ``fn()`` on ``side`` into the owner's pool; returns (the
        graph, the launch counters' change). The counters changed by the
        capture are recorded and put back: the capture runs nothing."""
        if torch.backends.cuda.matmul.allow_tf32:
            raise CaptureError("TF32 is on: the GEMMs must stay fp32 (the "
                               "package turns TF32 off at import)")
        before = launch._counters()
        g = torch.cuda.CUDAGraph()
        first = None  # the body's error: ending the capture raises another
        try:
            with torch.cuda.graph(g, pool=self.owner.pool, stream=side):
                try:
                    fn()
                except RuntimeError as e:
                    first = e
                    raise
        except RuntimeError as e:
            first = first or e
            raise CaptureError(f"capturing chunk program {repr(self.key)[:160]}"
                               f": {first} (at {_culprit(first)})") from first
        finally:
            after = launch._counters()
            launch._set_counters(before)
        if self.owner.pool is None:
            self.owner.pool = g.pool()
        return g, {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}


class SegmentedProgram(ChunkProgram):
    """A chunk program whose body holds collectives, which a graph cannot
    hold on gloo (see Collectives above): one captured graph for each
    segment between them, the collectives run eagerly between the
    segments' replays, in stream order.

    ``steps(inputs, carry, outputs)`` (the owner's static inputs and carry,
    and the outputs) returns the body as a list of ``(captured, fn)``. The
    steps run in order; the captured ones are the segments, and the others
    (the collectives) run at every call. A step reads and writes static
    buffers only (those three and whatever buffers the caller made for
    what crosses a collective), never a tensor that another step made: a
    segment's own tensors live in the graph pool only while it runs. The
    segment that ends the body writes the new carry into the static carry
    itself. Calls, the first run, the eager runs and the lifetime of the
    results are :class:`ChunkProgram`'s; each segment's replay adds the
    launches recorded at its capture to ``launch.REPLAYED``, and
    :attr:`launches` holds their sum (one run's)."""

    def __init__(self, owner: Programs, steps, inputs_like, carry_like,
                 outputs: tuple, key=None):
        super().__init__(owner, None, inputs_like, carry_like, outputs, key)
        self.steps = steps(self.inputs, self.carry, outputs)
