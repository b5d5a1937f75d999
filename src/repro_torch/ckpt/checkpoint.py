"""Async, atomic checkpointing with a self-healing restore.

Layout: <dir>/step_<n>/
    shard_0.npz         flat {index -> array} leaves
    manifest.json       treedef + leaf metadata
    COMMIT              written last: a checkpoint without it is ignored

The same files as the JAX package's ``repro.ckpt.checkpoint`` writes, so
either package reads a checkpoint of plain numpy arrays that the other
wrote.

* **Async**: ``save`` copies tensors to host memory synchronously and
  writes to disk on a background thread.
* **Atomic**: every marker file (manifest, COMMIT) is written to a temp
  name and ``os.replace``-d into place, and the step directory itself is
  assembled under a ``.tmp_`` name and renamed last — a crash at ANY
  point mid-``save`` leaves either the previous committed step or an
  uncommitted temp dir that ``latest_step`` ignores, never a
  half-written step that ``restore`` trusts.
* **Self-healing restore**: a committed step whose shard is corrupt or
  truncated (a torn write below the COMMIT rename, bit rot) is skipped
  with a warning and the previous committed step restored instead.
* **Positional trees**: ``save``/``restore`` flatten nested dicts, lists
  and tuples in JAX's pytree leaf order (dict keys sorted; ``None`` holds
  no leaf), so leaf ``i`` is the same leaf in both packages.  numpy has
  no bfloat16: a bfloat16 tensor travels as its int16 bits under the key
  ``"<i>:bf16"`` (``EngineSnapshot.to_arrays``'s convention).
* **Named-array checkpoints**: ``save_named``/``restore_named`` persist a
  flat ``{name: array}`` dict without a treedef or target shapes —
  entries may change shape between steps (the serving engine's pickled
  host state does), which the positional pair's shape check forbids.
* Retention: ``keep_last`` checkpoints are retained, older ones pruned.
* **Sharded states** (``mesh``, ``specs``: a train state each rank holds
  in blocks, ``dist/sharding.py``): saved as the JAX package saves one,
  whole leaves in the same files.  Every rank joins the gather of each
  leaf on its own thread (the writer thread calls no collective); rank 0
  alone writes.  ``wait`` then holds every rank until rank 0's write is
  committed, so that all read the same steps.  ``restore`` reads the whole
  leaves and gives each rank its block under its own ``specs``: a state
  saved on one mesh restores onto any other (JAX's elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_BF16 = ":bf16"


def _write_atomic(path: str, data: str) -> None:
    """Write ``data`` to ``path`` via a temp file + ``os.replace`` so a
    crash mid-write can never leave a truncated file under the final
    name."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> Tuple[List[Any], str]:
    """(leaves in JAX's pytree order, the structure's description).  The
    description reads like ``str`` of a JAX treedef (``*`` a leaf)."""
    leaves: List[Any] = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            return (f"CustomNode(namedtuple[{type(x).__name__}], ["
                    + ", ".join(walk(v) for v in x) + "])")
        if isinstance(x, (list, tuple)):
            inner = ", ".join(walk(v) for v in x)
            if isinstance(x, list):
                return f"[{inner}]"
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(like, leaves: List[Any]):
    """``like``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: build(x[k]) for k in sorted(x)}
        if _is_namedtuple(x):
            return type(x)(*(build(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return next(it)

    return build(like)


def flatten_up_to(like, tree) -> List[Any]:
    """The subtrees of ``tree`` at the positions of ``like``'s leaves, in
    ``like``'s leaf order (JAX's ``treedef.flatten_up_to``): e.g. each
    parameter's optimizer-state dict."""
    out: List[Any] = []

    def walk(x, t):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], t[k])
        elif isinstance(x, (list, tuple)):
            for a, b in zip(x, t):
                walk(a, b)
        else:
            out.append(t)

    walk(like, tree)
    return out


def _host(key: str, x) -> Tuple[str, np.ndarray]:
    """(file key, numpy array) of one leaf: a tensor is copied to the host
    (a CPU tensor too: the writer thread must not see a later in-place
    update, as the optimizers make), a bfloat16 one as its int16 bits
    under ``key + ":bf16"``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return key + _BF16, x.view(torch.int16).numpy()
        return key, x.numpy()
    return key, np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, mesh=None,
                 specs=None):
        """``mesh`` (this rank's ``launch.mesh.Mesh``) and ``specs`` (the
        state's ``PartitionSpec`` tree) for a sharded state: every rank
        makes its manager over the same directory."""
        if (mesh is None) != (specs is None):
            raise ValueError("a sharded state's manager takes both the mesh "
                             "and the specs")
        self.dir = directory
        self.keep_last = keep_last
        self.mesh, self.specs = mesh, specs
        self.writer = mesh is None or mesh.rank == 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0

    # ------------------------------------------------------------- saving
    def _write_step(self, step: int, named: Dict[str, np.ndarray],
                    extra_manifest: Dict[str, Any]) -> None:
        """Assemble step_<n> under a temp dir and rename it into place."""
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        # a stale temp dir from a previous crashed save must not leak
        # old shards into this attempt
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_0.npz"), **named)
        manifest = {
            "step": step,
            "n_leaves": len(named),
            "names": list(named),
            "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                       for a in named.values()],
            "time": time.time(),
        }
        manifest.update(extra_manifest)
        _write_atomic(os.path.join(tmp, "manifest.json"),
                      json.dumps(manifest))
        _write_atomic(os.path.join(tmp, "COMMIT"), "ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()
        self.save_count += 1

    def _write(self, step: int, named: Dict[str, np.ndarray],
               extra: Dict[str, Any], blocking: bool) -> None:
        self._join()                                 # one writer at a time
        if blocking:
            self._write_step(step, named, extra)
        else:
            self._thread = threading.Thread(
                target=self._write_step, args=(step, named, extra),
                daemon=True)
            self._thread.start()

    def save(self, step: int, state, blocking: bool = False) -> None:
        """Snapshot now; write in the background (unless blocking).  A
        sharded state's leaves are gathered whole first, one at a time,
        by every rank."""
        flat, treedef = tree_flatten(state)
        if self.mesh is not None:
            from repro_torch.dist.sharding import whole_of
            named = {}
            for i, (x, spec) in enumerate(zip(
                    flat, tree_flatten(self.specs)[0])):
                whole = whole_of(x.detach(), spec, self.mesh)
                if self.writer:
                    key, a = _host(str(i), whole)
                    named[key] = a
            if not self.writer:
                return
        else:
            named = dict(_host(str(i), x) for i, x in enumerate(flat))
        self._write(step, named, {"treedef": treedef}, blocking)

    def save_named(self, step: int, arrays: Dict[str, Any],
                   blocking: bool = False) -> None:
        """Persist a flat ``{name: array}`` dict (shapes may vary between
        steps — no treedef is recorded and ``restore_named`` needs no
        target structure)."""
        host = dict(_host(str(k), v) for k, v in arrays.items())
        self._write(step, host, {"named": True}, blocking)

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self) -> None:
        """Until the last save is written; for a sharded state, on every
        rank (a barrier over the mesh)."""
        self._join()
        if self.mesh is not None:
            self.mesh.barrier()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ loading
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "COMMIT")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_shard(self, step: int) -> Dict[str, np.ndarray]:
        """Read one step's shard fully into memory; raises on corruption
        (the fallback loop below catches and skips)."""
        path = os.path.join(self.dir, f"step_{step}", "shard_0.npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def _load_with_fallback(self, step: Optional[int]
                            ) -> Tuple[Dict[str, np.ndarray], int]:
        """Load ``step`` (default: latest), falling back to the previous
        committed step — with a warning naming the corrupt one — when a
        shard is truncated/corrupt.  Raises only when NO committed step
        is readable."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(
                f"no committed checkpoint in {self.dir}")
        if step is None:
            step = steps[-1]
        candidates = [s for s in steps if s <= step]
        if not candidates:
            raise FileNotFoundError(
                f"no committed checkpoint at or before step {step} in "
                f"{self.dir}")
        for s in reversed(candidates):
            try:
                return self._load_shard(s), s
            except (OSError, zipfile.BadZipFile, ValueError, KeyError,
                    EOFError) as e:
                warnings.warn(
                    f"checkpoint step_{s} is corrupt or truncated "
                    f"({type(e).__name__}: {e}); falling back to the "
                    "previous committed step", stacklevel=3)
        raise FileNotFoundError(
            f"every committed checkpoint at or before step {step} in "
            f"{self.dir} is corrupt")

    def restore(self, state_like, step: Optional[int] = None):
        """Returns ``(tree, step)``: a tree shaped like ``state_like`` whose
        leaves are numpy arrays, or CPU tensors where ``state_like``'s
        leaf is a tensor (bfloat16 ones back from their bits).  A
        corrupt/truncated shard under a COMMIT marker is skipped with a
        warning and the previous committed step restored instead; the
        returned step says which one actually loaded.  For a sharded
        state (``state_like`` this rank's blocks) each leaf is this rank's
        block of the whole leaf on disk.
        """
        shard, step = self._load_with_fallback(step)
        targets, _ = tree_flatten(state_like)
        if len(targets) != len(shard):
            raise ValueError(f"checkpoint step_{step} holds {len(shard)} "
                             f"leaves, the target {len(targets)}")
        specs = (None if self.mesh is None
                 else tree_flatten(self.specs)[0])
        if specs is not None:
            from repro_torch.dist.sharding import block_of, whole_shape
        flat = []
        for i, tgt in enumerate(targets):
            bits = shard.get(str(i) + _BF16)
            got = shard[str(i)] if bits is None else bits
            want = tuple(tgt.shape) if specs is None else whole_shape(
                tgt.shape, specs[i], self.mesh)
            if want != tuple(got.shape):
                raise ValueError(
                    f"checkpoint leaf {got.shape} != target {want} — "
                    "restore requires matching shapes")
            if isinstance(tgt, torch.Tensor):
                got = torch.from_numpy(np.array(got, copy=True))
                if bits is not None:
                    got = got.view(torch.bfloat16)
                if specs is not None:
                    got = block_of(got, specs[i], self.mesh).clone()
            flat.append(got)
        return tree_unflatten(state_like, flat), step

    def restore_named(self, step: Optional[int] = None
                      ) -> Tuple[Dict[str, np.ndarray], int]:
        """Load a ``save_named`` checkpoint back as ``{name: array}``,
        with the same corrupt-shard skip-and-warn fallback."""
        return self._load_with_fallback(step)
