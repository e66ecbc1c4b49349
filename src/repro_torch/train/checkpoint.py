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
matching leaf of ``like`` (the reference re-applies a mesh's shardings
there; restoring onto a mesh waits for training over one, ROADMAP.md
queue A, item 23).
"""
from __future__ import annotations

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


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> None:
        """Snapshot ``tree`` (dicts and lists of tensors) at ``step``.

        Blocks on a previous async save, then copies every leaf to the
        host before the writer thread starts, so that the caller may
        update its tensors at once: that copy waits for the device's
        queued work (a device sync) and takes the tree's bytes of host
        memory."""
        self.wait()
        host = [(_name(path),) + _to_numpy(t) for path, t in flatten(tree)]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, step: int, like: Any):
        """The tree of ``like`` (dicts and lists of tensors) with every leaf
        read from checkpoint ``step``, in its saved dtype, on the device of
        ``like``'s leaf. Checks each tensor's crc32 and shape; raises
        ValueError on corruption or a shape that is not ``like``'s, and
        KeyError for a leaf the checkpoint lacks."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        blob = (d / "data.bin").read_bytes()
        by_name = {t["name"]: t for t in manifest["tensors"]}
        out = []
        for path, leaf in flatten(like):
            name = _name(path)
            t = by_name[name]
            raw = blob[t["offset"]:t["offset"] + t["nbytes"]]
            if zlib.crc32(raw) != t["crc32"]:
                raise ValueError(f"checkpoint corruption in tensor {name}")
            if list(leaf.shape) != list(t["shape"]):
                raise ValueError(f"tensor {name} has shape {t['shape']} in "
                                 f"the checkpoint, {list(leaf.shape)} here")
            out.append((path, _from_bytes(raw, t["dtype"], t["shape"])
                         .to(leaf.device)))
        return unflatten(out)

    def restore_latest(self, like: Any):
        """(step, tree) of the newest valid checkpoint, skipping corrupt
        ones; (None, None) if there is none."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, like)
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                print(f"[ckpt] step {step} unusable ({e}); trying previous")
        return None, None
