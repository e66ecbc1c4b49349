"""Fault-tolerant checkpointing, after the JAX package's
``repro.train.checkpoint``, in its on-disk format, so that each package
restores the other's checkpoints.

Format: one directory ``step_{:010d}`` per step, holding
  manifest.json : {"step", "tensors": [{name, shape, dtype, offset,
                  nbytes, crc32}, ...]}, one entry per leaf
  data.bin      : the leaves' raw little-endian bytes, concatenated

A leaf's name is its tree path, dict keys (sorted, as ``jax.tree_util``
flattens them) and list indices joined by "/": ``params/blocks/0/k0_self/
attn/wq``, ``opt/count``. ``dtype`` is the numpy name of the leaf's dtype,
``bfloat16`` for bf16 leaves, whose bits travel through an int16 view
(numpy has no bfloat16 of its own; ``repro_torch.convert`` does the same).

Fault-tolerance properties, the reference's:
  * atomic publish   - written to ``<dir>.tmp``, data fsync'd, then renamed
  * corruption check - crc32 per tensor, checked on restore; a corrupt
                       checkpoint is skipped and the one before restored
  * keep-k           - older steps removed after each publish
  * async            - ``save`` writes on a background thread and blocks
                       only on the previous save
Arrays are saved whole; ``restore`` puts each leaf on the device of the
matching leaf of ``like``.

Over a mesh (``specs`` and ``mesh``: a ``DeviceMesh`` of more than one
position, every rank holding its shards of each leaf by its spec, as
``train.steps.TrainPlan`` stores them) ``save`` gathers the logical tree
(a collective: every rank calls it) and the rank at the mesh's origin
writes it, so a checkpoint saved from a mesh is the single-device one of
the same state, byte for byte; ``wait`` returns on every rank once that
write is published (a barrier). ``restore(step, like, specs, mesh)``
reads each whole leaf and gives the rank its shard, ``like``'s leaf being
that shard: the reference's ``shardings`` argument. Checkpoints hold no
mesh, so a run restores onto a mesh of another shape, or onto one device
(the reference's elastic re-mesh).
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import flatten, unflatten
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (axis_sizes, entry_axes,
                                           mesh_positions, slice_leaf)


def _name(path) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` and its numpy dtype name (bf16 as int16 bits)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=dtype)
                            .reshape(shape).copy())


def _whole_shape(shape, spec, mesh) -> list:
    """The whole shape of a leaf whose shard on ``mesh`` by ``spec`` has
    ``shape``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for ax in entry_axes(entry):
            out[d] *= sizes[ax]
    return out


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._mesh = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, specs: Any = None,
             mesh: Any = None) -> None:
        """Snapshot ``tree`` (dicts and lists of tensors) at ``step``.

        Blocks on a previous async save, then copies every leaf to the
        host before the writer thread starts, so that the caller may
        update its tensors at once: that copy waits for the device's
        queued work (a device sync) and takes the tree's bytes of host
        memory. With ``specs`` and a ``mesh`` of more than one position,
        ``tree`` holds this rank's shards: they are gathered whole on
        every rank (collective), and the mesh's origin rank writes."""
        self.wait()
        if mesh_positions(mesh) > 1:
            tree = C.gather_tree(tree, specs, mesh)
            self._mesh = mesh
            if any(mesh.get_local_rank(a) for a in mesh.mesh_dim_names):
                return
        host = [(_name(path),) + _to_numpy(t) for path, t in flatten(tree)]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        """Return once the last save is published; after a save from a
        mesh, on every rank of it (collective)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            C.barrier(mesh)

    def _write(self, step: int, host: List[Tuple[str, np.ndarray, str]]):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "tensors": []}
        with open(tmp / "data.bin", "wb") as f:
            off = 0
            for name, arr, dtype in host:
                raw = np.ascontiguousarray(arr).tobytes()
                manifest["tensors"].append({
                    "name": name, "shape": list(arr.shape), "dtype": dtype,
                    "offset": off, "nbytes": len(raw),
                    "crc32": zlib.crc32(raw)})
                f.write(raw)
                off += len(raw)
            f.flush()
            os.fsync(f.fileno())
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, specs: Any = None,
                mesh: Any = None):
        """The tree of ``like`` (dicts and lists of tensors) with every leaf
        read from checkpoint ``step``, in its saved dtype, on the device of
        ``like``'s leaf. Checks each tensor's crc32 and shape; raises
        ValueError on corruption or a shape that is not ``like``'s, and
        KeyError for a leaf the checkpoint lacks. With ``specs`` and a
        ``mesh`` of more than one position, ``like``'s leaves are this
        rank's shards: each saved leaf must have the whole shape those
        specs give, and the rank receives its shard (no collective)."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        blob = (d / "data.bin").read_bytes()
        by_name = {t["name"]: t for t in manifest["tensors"]}
        sharded = mesh_positions(mesh) > 1
        out = []
        for path, leaf in flatten(like):
            name = _name(path)
            t = by_name[name]
            raw = blob[t["offset"]:t["offset"] + t["nbytes"]]
            if zlib.crc32(raw) != t["crc32"]:
                raise ValueError(f"checkpoint corruption in tensor {name}")
            spec = functools.reduce(lambda n, k: n[k], path, specs) \
                if sharded else None
            want = (_whole_shape(leaf.shape, spec, mesh) if sharded
                    else list(leaf.shape))
            if want != list(t["shape"]):
                raise ValueError(f"tensor {name} has shape {t['shape']} in "
                                 f"the checkpoint, {want} here")
            full = _from_bytes(raw, t["dtype"], t["shape"])
            if sharded:
                full = slice_leaf(full, spec, mesh).clone()
            out.append((path, full.to(leaf.device)))
        return unflatten(out)

    def restore_latest(self, like: Any, specs: Any = None, mesh: Any = None):
        """(step, tree) of the newest valid checkpoint, skipping corrupt
        ones; (None, None) if there is none."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, like, specs, mesh)
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                print(f"[ckpt] step {step} unusable ({e}); trying previous")
        return None, None
