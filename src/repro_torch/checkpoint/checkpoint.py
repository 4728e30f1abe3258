"""Fault-tolerant checkpoints of a tree of tensors — params, optimizer
state — in the reference's format.

Counterpart of ``repro/checkpoint/checkpoint.py``: one ``.npz`` a step,
each leaf under its ``jax.tree_util.keystr`` path
(:func:`repro_torch.tree.paths`: ``['params']['layers']['attn']['wq']``);
a bfloat16 leaf stored as its uint16 view, named in a JSON sidecar under
``__dtypes__`` (``"bfloat16"``); a ``.done`` marker carrying the step and
the reference's sampled digest. So a file either package writes, the
other reads, and reading needs no numpy bfloat16 type. Writes are
atomic (a temporary name, then ``os.replace``); ``CheckpointManager``
keeps the newest ``keep`` steps, writes on a background thread when
asked, and ``restore_latest`` skips a step that fails to load.

A state trained over a mesh — per-rank trees and their
:class:`~repro_torch.distributed.sharding.Placement` — is saved as the
same whole-leaf file (``save(..., placement=)``): the shards are copied
to the host leaf by leaf, synchronously, and assembled there, as the
reference's ``device_get`` gathers a sharded array; no device holds a
leaf it does not own. ``restore_latest(like, shardings=)`` re-shards
what it reads onto a placement's mesh — the same mesh, or another
device count.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import warnings
import zipfile

import numpy as np
import torch

from repro_torch import tree as T

_DTYPES_KEY = "__dtypes__"
# leaves numpy stores as they are; bfloat16 goes as a same-width view
_NP_OF = {torch.float32: np.float32, torch.float64: np.float64,
          torch.float16: np.float16, torch.int8: np.int8,
          torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.uint8: np.uint8, torch.bool: np.bool_}


def _host(leaf) -> tuple[np.ndarray, str | None]:
    """(the array to store, its sidecar dtype name or None)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    if t.dtype not in _NP_OF:
        raise TypeError(f"checkpoint: no storage for dtype {t.dtype}")
    return t.numpy(), None


def _flatten(tree) -> dict:
    out, ext = {}, {}
    for key, leaf in T.paths(tree):
        out[key], name = _host(leaf)
        if name is not None:
            ext[key] = name
    if ext:
        out[_DTYPES_KEY] = np.frombuffer(json.dumps(ext).encode(),
                                         dtype=np.uint8).copy()
    return out


def _tensor(arr: np.ndarray, name: str | None, like) -> torch.Tensor:
    """A stored array as a tensor on ``like``'s device (the host for a
    non-tensor ``like``); a bfloat16 one from its uint16 view."""
    if name is not None and name != "bfloat16":
        raise TypeError(f"checkpoint: stored dtype {name!r} has no tensor "
                        "type here")
    if name == "bfloat16":
        arr = arr.view(np.int16)
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    if torch.device(dev).type == "cpu" or not arr.flags.c_contiguous:
        arr = np.array(arr)   # a writable host copy to keep
    with warnings.catch_warnings():   # read-only: only copied from below
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(dev)


def _unflatten(like, arrays: dict):
    ext = {}
    if _DTYPES_KEY in arrays:
        ext = json.loads(bytes(arrays[_DTYPES_KEY].tobytes()).decode())
    leaves = []
    for key, leaf in T.paths(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        want = getattr(leaf, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(want)}")
        leaves.append(_tensor(arr, ext.get(key), leaf))
    return T.unflatten(like, leaves)


def _digest(arrays: dict) -> str:
    """The reference's marker digest: keys, shapes, dtypes and the first
    4096 bytes of each array (the zip's CRC guards the rest)."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        a = arrays[k]
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        # the first 4096 bytes, without copying the rest
        head = a.reshape(-1)[:-(-4096 // max(a.itemsize, 1))]
        h.update(head.tobytes()[:4096] if a.size else b"")
    return h.hexdigest()[:16]


def _savez(f, arrays: dict) -> None:
    """``np.savez``'s file — a stored zip of one ``.npy`` per array —
    written from each array's own buffer (``np.savez`` copies each in
    16 MiB chunks first)."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, a in arrays.items():
            a = a if a.flags.c_contiguous else np.array(a, order="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(
                    fid, np.lib.format.header_data_from_array_1_0(a))
                if a.size:
                    fid.write(memoryview(a.reshape(-1)).cast("B"))


def _write(path: str, arrays: dict, marker: dict) -> None:
    """The npz, then its ``.done`` marker, each through a temporary name
    and ``os.replace``: a killed writer never leaves a step that looks
    valid."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        _savez(f, arrays)
    os.replace(tmp, path)
    mtmp = path + ".done.tmp"
    with open(mtmp, "w") as f:
        json.dump({"digest": _digest(arrays), **marker}, f)
    os.replace(mtmp, path + ".done")


def save_pytree(path: str, tree, *, extra: dict | None = None) -> str:
    """Atomic single-file save. Returns the digest."""
    arrays = _flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write(path, arrays, extra or {})
    return _digest(arrays)


def load_pytree(path: str, like):
    """Load into the structure of ``like`` (shapes checked); each leaf
    on the device of ``like``'s leaf."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    return _unflatten(like, arrays)


_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


class CheckpointManager:
    """Keep-k checkpoint directory, writing synchronously or on a
    background thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.npz")

    def steps(self) -> list[int]:
        """Valid checkpoint steps (marker present), ascending."""
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name + ".done")):
                out.append(int(m.group(1)))
        return sorted(out)

    def wait(self) -> None:
        """Join the background write, if one is running."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, *, blocking: bool = True,
             extra: dict | None = None, placement=None) -> None:
        """Copy ``tree`` to the host now (the card's values as of this
        call, before any later step writes them); write now, or on a
        background thread (``blocking=False``) that the next save or
        :meth:`wait` joins. With ``placement`` (a ``sharding.
        Placement``), ``tree`` is per-rank trees, gathered whole on the
        host leaf by leaf."""
        self.wait()
        if placement is not None:
            tree = placement.gather(tree, "cpu")
        arrays = _flatten(tree)
        path = self._path(step)
        marker = {"step": step, **(extra or {})}

        def write():
            _write(path, arrays, marker)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:max(0, len(steps) - self.keep)]:
            for suffix in ("", ".done"):
                try:
                    os.remove(self._path(s) + suffix)
                except OSError:
                    pass

    def restore_latest(self, like, *, shardings=None):
        """(step, tree) from the newest step that loads, each leaf on the
        device of ``like``'s; (None, None) when none does. A step whose
        file fails to load (a partial write whose marker survived, a
        zip CRC error) is skipped for the one before it.

        With ``shardings`` (a ``sharding.Placement``) the tree read is
        re-sharded onto its mesh: per-rank trees, each shard on its
        rank's device. ``like`` is then per-rank trees placed by
        ``shardings`` (a replay on the same mesh), or a tree of the whole
        leaves' shapes — meta tensors will do — to restore onto another
        mesh."""
        self.wait()
        if shardings is not None:
            like = _whole_like(like, shardings)
        for step in reversed(self.steps()):
            try:
                tree = load_pytree(self._path(step), like)
            except Exception:  # noqa: BLE001 — corrupt: try older
                continue
            if shardings is not None:
                tree = shardings.shard(tree)
            return step, tree
        return None, None


def _whole_like(like, placement):
    """A host tree of the whole leaves' shapes and dtypes (no storage):
    from per-rank trees (a list, one tree a rank) by ``placement``, else
    ``like``'s own — so the file is read onto the host, then sharded."""
    if isinstance(like, list):
        return placement.whole_like(like[0])
    return T.tree_map(lambda t: torch.empty((), dtype=t.dtype).expand(
        tuple(t.shape)), like)
