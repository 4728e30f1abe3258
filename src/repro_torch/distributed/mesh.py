"""A (data, model) or (pod, data, model) mesh of devices driven from
one process.

Counterpart of ``jax.sharding.Mesh`` as the serving engine uses it: one
controller, one worker thread per rank (``torch.nn.DataParallel``'s
``parallel_apply`` idiom). Each rank runs the port's model functions on
its own shard, under its own device (the current CUDA device is
thread-local), and the ranks meet only in its collectives:
:meth:`DeviceMesh.all_gather`, which concatenates their tensors in fixed
rank order onto each rank's device, and :meth:`~DeviceMesh.all_reduce`
and :meth:`~DeviceMesh.reduce_scatter`, which sum them in rank order on
each rank's device, so every rank gets the same bits. A cross-device
``.to()`` orders itself against both devices' current streams, and the
barrier in front of it means the producing rank has already queued the
work that makes its tensor.

Rank ``r`` sits at its coordinates in row-major order over the axes —
``(data, model) = divmod(r, model_size)`` on two, ``(pod, data,
model)`` on three, as ``jax.make_mesh`` lays out ``("pod", "data",
"model")``. A collective runs over one axis or over several flattened in
the order named (the FSDP group ``("pod", "data")``, pod-major). A
device may be named more than once: several shards then share it, and a
gather between them is a local copy — the same code path and the same
kernels.

An exception in any rank aborts every barrier of the mesh, so no rank is
left waiting, and :meth:`DeviceMesh.run` raises it in the caller.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import queue
import threading
import weakref

import torch

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")   # a two-axis mesh has the last two

# a rank waits at most this long for the others at one gather before
# the mesh gives up on the call (a rank that hangs instead of raising)
BARRIER_TIMEOUT_S = 600.0


class PerRank(list):
    """One value per rank of a mesh, in rank order (None where a rank
    takes no part): a dispatch operand or result that differs by rank."""


class _Exchange:
    """The meeting point of one group of ranks: a barrier and two slot
    lists used alternately, so a gather needs one barrier — a rank can
    only overwrite a list after every rank has passed the next gather's
    barrier, and so has read this one."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = ([None] * n, [None] * n)


class DeviceMesh:
    """``shape`` (data, model) or (pod, data, model) ranks over
    ``devices`` (the product of the sizes, ``torch.device``\\ s or
    strings, in rank order)."""

    def __init__(self, shape, devices, *, timeout: float = BARRIER_TIMEOUT_S):
        shape = tuple(int(x) for x in shape)
        if len(shape) not in (2, 3) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape!r} must be two or three "
                             "positive axis sizes: (data, model) or (pod, "
                             "data, model)")
        devs = tuple(resolve_device(x) for x in devices)
        n = math.prod(shape)
        if len(devs) != n:
            raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {n} "
                             f"devices, got {len(devs)}")
        self.shape = shape
        self.axes = AXES[-len(shape):]
        self.devices = devs
        self.size = n
        self.timeout = timeout
        self._local = threading.local()
        self._shared = _Shared()
        self._queues = None
        self._threads: list[threading.Thread] = []
        self._n_threads = torch.get_num_threads()

    # -- coordinates -------------------------------------------------------
    def axis_size(self, axis: str) -> int:
        """The size of ``axis`` (1 for an axis the mesh lacks)."""
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def coords(self, rank: int) -> tuple:
        """``rank``'s coordinates, one per axis of the mesh."""
        out = []
        for n in reversed(self.shape):
            rank, c = divmod(rank, n)
            out.append(c)
        return tuple(reversed(out))

    def rank_of(self, *coords: int) -> int:
        r = 0
        for c, n in zip(coords, self.shape):
            r = r * n + c
        return r

    def group(self, rank: int, axis) -> tuple:
        """The ranks that share ``rank``'s other coordinates, in order
        over ``axis`` — one axis name, or several flattened row-major in
        the order given (``("pod", "data")``: pod-major). An axis the
        mesh lacks has size 1."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r}: {AXES}")
        names = tuple(a for a in names if a in self.axes)
        base = list(self.coords(rank))
        out = []
        for idx in itertools.product(*(range(self.axis_size(a))
                                        for a in names)):
            c = list(base)
            for a, i in zip(names, idx):
                c[self.axes.index(a)] = i
            out.append(self.rank_of(*c))
        return tuple(out)

    def data_group(self, data: int) -> tuple:
        """The ``model`` ranks of data replica ``data`` (a two-axis
        mesh)."""
        return tuple(self.rank_of(data, j) for j in range(self.shape[1]))

    def rank(self) -> int | None:
        """The rank the calling thread runs (None outside :meth:`run`)."""
        return getattr(self._local, "rank", None)

    # -- workers -----------------------------------------------------------
    def _start(self) -> None:
        # the threads hold the shared state, never the mesh itself, so a
        # mesh nobody references is collected and its finalizer stops them
        self._queues = [queue.SimpleQueue() for _ in range(self.size)]
        for r in range(self.size):
            t = threading.Thread(
                target=_serve, args=(r, self.devices[r], self._queues[r],
                                     self._local, self._shared,
                                     self._n_threads),
                name=f"mesh-rank-{r}", daemon=True)
            t.start()
            self._threads.append(t)
        self._finalizer = weakref.finalize(self, _stop, self._queues,
                                           self._threads)

    def _reset(self) -> None:
        with self._shared.lock:
            for ex in self._shared.exchanges.values():
                ex.barrier.reset()
                for slots in ex.slots:
                    slots[:] = [None] * len(slots)

    def run(self, fn, ranks=None) -> list:
        """``fn(rank)`` on each of ``ranks`` (default every rank), each on
        its own thread under its device; returns the results in rank
        order, None for a rank that did not run. An exception in any
        rank is raised here once every rank has returned."""
        ranks = tuple(range(self.size)) if ranks is None else tuple(ranks)
        if self._queues is None:
            self._start()
        call = _Call(self.size, ranks)
        for r in ranks:
            self._queues[r].put((fn, call))
        for _ in ranks:
            call.done.acquire()
        if call.errors:
            self._reset()
            errs = [call.errors[r] for r in sorted(call.errors)]
            first = next((e for e in errs
                          if not isinstance(e, threading.BrokenBarrierError)),
                         errs[0])
            if isinstance(first, threading.BrokenBarrierError):
                raise RuntimeError(
                    f"mesh call on ranks {ranks}: a rank waited more than "
                    f"{self.timeout} s for the others at a gather") from first
            raise first
        return call.results

    def close(self) -> None:
        """Stop the worker threads (the mesh restarts them on the next
        :meth:`run`)."""
        if self._queues is None:
            return
        self._finalizer()
        self._queues, self._threads = None, []

    # -- collectives -------------------------------------------------------
    def current_call(self):
        """The :meth:`run` the calling thread serves (None outside one):
        a collective made on another thread on a rank's behalf (autograd's
        worker for the rank's device) passes it, with the rank."""
        return getattr(self._local, "call", None)

    def _exchange(self, grp: tuple) -> _Exchange:
        with self._shared.lock:
            ex = self._shared.exchanges.get(grp)
            if ex is None:
                ex = self._shared.exchanges[grp] = _Exchange(len(grp),
                                                             self.timeout)
            return ex

    def _meet(self, x, axis, what, rank, call):
        """Post ``x`` for the calling rank's ``axis`` group and wait for the
        others: (group, the group's posted tensors in group order, this
        rank's device). ``rank`` and ``call`` default to the calling
        thread's."""
        rank = self.rank() if rank is None else rank
        call = self.current_call() if call is None else call
        if rank is None or call is None:
            raise RuntimeError(f"{what} runs inside DeviceMesh.run, or is "
                               "given the rank and its call")
        grp = self.group(rank, axis)
        dev = self.devices[rank]
        if len(grp) == 1:
            return grp, [x], dev
        if not call.ranks.issuperset(grp):
            raise RuntimeError(f"{what} over {axis!r} needs ranks {grp}, "
                               f"but this call runs {sorted(call.ranks)}")
        ex = self._exchange(grp)
        if call.aborted:   # a rank failed before this group's barrier
            raise threading.BrokenBarrierError   # existed to be broken
        # which of the two slot lists: the parity of this rank's gathers
        # in the group during this call (every rank of it counts alike)
        counts = call.gathers[rank]
        k = counts.get(grp, 0)
        counts[grp] = k + 1
        slots = ex.slots[k % 2]
        slots[grp.index(rank)] = x
        # the baton is released by whichever thread waits here: the rank's
        # own, or autograd's worker running the rank's backward while the
        # rank's thread waits for it
        self._shared.baton.release()
        try:
            ex.barrier.wait()
        finally:
            self._shared.baton.acquire()
        return grp, list(slots), dev

    def all_gather(self, x: torch.Tensor, dim: int, axis: str, *,
                   rank: int | None = None, call=None) -> torch.Tensor:
        """Called by every rank of the calling rank's ``axis`` group:
        their ``x`` concatenated along ``dim`` in group order, on the
        calling rank's device. A group of one returns ``x``."""
        grp, parts, dev = self._meet(x, axis, "all_gather", rank, call)
        if len(grp) == 1:
            return x
        return torch.cat([t if t.device == dev else t.to(dev)
                          for t in parts], dim)

    def all_reduce(self, x: torch.Tensor, axis: str, *,
                   rank: int | None = None, call=None) -> torch.Tensor:
        """Called by every rank of the calling rank's ``axis`` group: the
        sum of their ``x``, added left to right in group order in float32
        on the calling rank's device and returned in x's dtype — every
        rank of the group gets the same bits. No float atomics, no
        library collective. A group of one returns ``x``."""
        grp, parts, dev = self._meet(x, axis, "all_reduce", rank, call)
        if len(grp) == 1:
            return x
        return _ordered_sum([t.to(dev) for t in parts]).to(x.dtype)

    def reduce_scatter(self, x: torch.Tensor, dim: int, axis: str, *,
                       rank: int | None = None, call=None) -> torch.Tensor:
        """Called by every rank of the calling rank's ``axis`` group,
        each with ``x`` of the same shape: the calling rank's chunk along
        ``dim`` (the group's size of them, in group order) of the sum of
        their ``x``, summed as :meth:`all_reduce` sums. A group of one
        returns ``x``."""
        grp, parts, dev = self._meet(x, axis, "reduce_scatter", rank, call)
        if len(grp) == 1:
            return x
        rank = self.rank() if rank is None else rank
        w = x.shape[dim] // len(grp)
        i = grp.index(rank) * w
        return _ordered_sum([t.narrow(dim, i, w).to(dev)
                             for t in parts]).to(x.dtype)


def _ordered_sum(parts) -> torch.Tensor:
    """parts[0] + parts[1] + ... in float32, left to right."""
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p.float()
    return out


class _Shared:
    """What the worker threads share with the mesh: its exchanges, their
    lock, and the baton — the one rank that runs Python at a time holds
    it, and gives it up only to wait at a gather. The interpreter runs
    one thread at a time anyway; without the baton every torch op of
    every rank would hand the interpreter lock to another thread (a
    context switch per op), with it a rank switches once a gather."""

    def __init__(self):
        self.lock = threading.Lock()
        self.exchanges: dict[tuple, _Exchange] = {}
        self.baton = threading.Lock()

    def abort(self) -> None:
        """Break every barrier: ranks waiting at a gather raise."""
        with self.lock:
            for ex in self.exchanges.values():
                ex.barrier.abort()


def _serve(rank, dev, q, local, shared, n_threads) -> None:
    """A rank's worker: run each task's ``fn(rank)`` under ``dev`` until
    the None that stops it."""
    torch.set_num_threads(n_threads)
    local.rank = rank
    while True:
        task = q.get()
        if task is None:
            return
        fn, call = task
        local.call = call
        try:
            ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
            with ctx, shared.baton:
                call.results[rank] = fn(rank)
        except BaseException as e:   # noqa: BLE001 — re-raised by run
            call.errors[rank] = e
            call.aborted = True
            shared.abort()
        finally:
            local.call = None
            call.done.release()
            # hold nothing of the task while waiting for the next: its
            # closure may reference a whole shard of weights
            del task, fn, call


def _stop(queues, threads) -> None:
    """Stop a mesh's workers and wait for them (also at interpreter exit:
    no worker may still run torch code while the interpreter tears
    down)."""
    for q in queues:
        q.put(None)
    for t in threads:
        if t is not threading.current_thread():
            t.join()


class _Call:
    """One :meth:`DeviceMesh.run`: the ranks it runs, per-rank results,
    errors and gather counts, and a semaphore the caller takes once per
    rank."""

    def __init__(self, n: int, ranks):
        self.ranks = frozenset(ranks)
        self.results: list = [None] * n
        self.errors: dict[int, BaseException] = {}
        self.gathers: list[dict] = [{} for _ in range(n)]
        self.aborted = False
        self.done = threading.Semaphore(0)


def mesh_devices(shape, devices=None) -> tuple:
    """The devices of a mesh of ``shape`` (the product of its sizes):
    ``devices`` as given (a name may repeat: several shards on one
    device), or the first that many visible CUDA devices — raising where
    there are fewer, as the reference does, and never falling back to
    the CPU."""
    n = math.prod(int(x) for x in shape)
    if devices is not None:
        devs = [resolve_device(x) for x in devices]
        if len(devs) < n:
            raise ValueError(f"mesh={tuple(shape)} needs {n} devices, but "
                             f"only {len(devs)} are in the device group")
        return tuple(devs[:n])
    resolve_device("cuda")
    count = torch.cuda.device_count()
    if count < n:
        raise ValueError(f"mesh={tuple(shape)} needs {n} devices, but only "
                         f"{count} are visible to torch")
    return tuple(torch.device("cuda", i) for i in range(n))
