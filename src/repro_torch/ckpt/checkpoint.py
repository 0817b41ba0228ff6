"""Fault-tolerant checkpointing of torch state: the port's copy of the JAX
package's ``repro.ckpt.checkpoint``, with its layout.

  * a checkpoint is ``<dir>/step_XXXXXXXXXX/`` holding ``arrays.npz`` (one
    array per leaf, keyed by its path joined by ``/``) and ``meta.json``
    (step, time, keys, the caller's ``extra``);
  * atomic commit: written to ``<dir>/.tmp_step_XXXXXXXXXX``, the metadata
    fsynced, then renamed, so a crash mid-save never corrupts the latest
    checkpoint, and restore never sees a ``.tmp_`` directory;
  * async save: the device-to-host copy happens on the caller's thread,
    serialization on a writer thread, so training continues;
  * retention: the last ``keep`` checkpoints are kept; older ones go only
    AFTER the newest commit succeeds.

Leaves are saved as full arrays, so any device can restore them, and a
checkpoint restores onto any mesh (elastic scaling after node loss):
``load_checkpoint(..., mesh, shardings)`` distributes each leaf with the
placements ``dist.sharding.Rules.tree_shardings`` gives.  A ``DTensor``
leaf is saved as its full logical value (``full_tensor()``, a collective
every rank makes); under ``torch.distributed`` rank 0 writes.  numpy has
no bf16: a bf16 leaf is saved as its raw 16-bit words (``int16``) and
``meta.json``'s ``dtypes`` names it, so it round-trips bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import tree
from repro_torch.dist import context as dist_ctx

_RAW = {torch.bfloat16: torch.int16}   # dtypes numpy lacks -> their words


def _to_numpy(leaf, dtypes, key):
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype in _RAW:
        dtypes[key] = str(t.dtype).removeprefix("torch.")
        t = t.view(_RAW[t.dtype])
    return t.numpy()


def _to_tensor(a, dtype_name=None):
    t = torch.from_numpy(np.array(a))
    return t.view(getattr(torch, dtype_name)) if dtype_name else t


def _host(tree_, copy=False):
    """``tree_`` on the host (a copy with ``copy``), each ``DTensor`` leaf
    gathered to its full value (a collective every rank makes)."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        return t.detach().to("cpu", copy=copy)
    return tree.map_tree(leaf, tree_)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, tree_: Any,
                    extra: Optional[Dict] = None) -> Path:
    """Synchronous atomic save of a tree of tensors (or arrays).  Returns
    the committed path.  Under ``torch.distributed`` every rank calls it:
    rank 0 writes, and the others wait until it has committed."""
    host = _host(tree_)
    final = Path(directory) / f"step_{step:010d}"
    if _writes():
        _write(directory, step, host, extra)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return final


def _write(directory: str, step: int, tree_: Any,
           extra: Optional[Dict] = None) -> Path:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step:010d}"
    tmp = d / f".tmp_step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    dtypes: Dict[str, str] = {}
    arrays = {k: _to_numpy(v, dtypes, k) for k, v in tree.flatten(tree_).items()}
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {"step": step, "time": time.time(),
            "keys": sorted(arrays.keys()), "extra": extra or {},
            "dtypes": dtypes}
    (tmp / "meta.json").write_text(json.dumps(meta))
    with open(tmp / "meta.json") as f:  # fsync the metadata
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def load_checkpoint(directory: str, step: Optional[int] = None,
                    mesh=None, shardings: Optional[Any] = None,
                    template: Optional[Any] = None) -> Dict:
    """Load the latest (or given) step.  With ``template`` (a tree of
    tensors), returns ``{"step", "tree", "extra"}``, the tree in the
    template's structure with each leaf on its template leaf's device;
    else ``{"step", "arrays", "extra"}``, ``arrays`` {key: CPU tensor}.
    With ``shardings`` too (the template's tree with a tuple of
    ``DTensor`` placements, or None, at each leaf, as
    ``Rules.tree_shardings`` gives), each leaf is distributed onto
    ``mesh`` (by default the active one) with its placements, from the
    full value every rank reads: restoring onto another mesh than the one
    that saved just works, because saved arrays are full logical values."""
    d = Path(directory)
    ckpts = sorted(p for p in d.glob("step_*") if p.is_dir())
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {d}")
    path = ckpts[-1] if step is None else d / f"step_{step:010d}"
    meta = json.loads((path / "meta.json").read_text())
    dtypes = meta.get("dtypes", {})
    with np.load(path / "arrays.npz") as f:
        arrays = {k: _to_tensor(f[k], dtypes.get(k)) for k in f.files}
    if template is None:
        return {"step": meta["step"], "arrays": arrays,
                "extra": meta["extra"]}
    flat = {k: arrays[k].to(t.device) if isinstance(t, torch.Tensor)
            else arrays[k] for k, t in tree.flatten(template).items()}
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor
        mesh = mesh if mesh is not None else dist_ctx.get_mesh()
        if mesh is None:
            raise ValueError("shardings need a mesh")
        dev = torch.device(mesh.device_type) if mesh.device_type == "cpu" \
            else torch.device(mesh.device_type, torch.cuda.current_device())
        # the placements are tuples: leaves, where the layers are a list
        for k, placements in tree.flatten(shardings,
                                          containers=list).items():
            if placements is None:   # as the reference: not distributed
                continue
            flat[k] = distribute_tensor(flat[k].to(dev), mesh, placements,
                                        src_data_rank=None)
    return {"step": meta["step"], "tree": tree.unflatten(template, flat),
            "extra": meta["extra"]}


class CheckpointManager:
    """Async save + retention + crash recovery."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save_async(self, step: int, tree_: Any,
                   extra: Optional[Dict] = None):
        """Copies ``tree_`` to the host now (training may then update it in
        place) and writes it on a writer thread; one save in flight at a
        time.  A failed save raises from the next call of ``wait``.  Under
        ``torch.distributed`` every rank calls it (``DTensor`` leaves are
        gathered), and rank 0 writes."""
        self.wait()
        host = _host(tree_, copy=True)
        if not _writes():
            return

        def work():
            try:
                _write(str(self.dir), step, host, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._err = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_*"))
        return int(ckpts[-1].name.split("_")[1]) if ckpts else None

    def restore(self, **kw):
        return load_checkpoint(str(self.dir), **kw)

    def _gc(self):
        ckpts = sorted(p for p in self.dir.glob("step_*") if p.is_dir())
        for p in ckpts[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
