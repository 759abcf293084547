"""Fault-tolerant checkpointing, the port of
``repro.checkpoint.manager`` with its on-disk format.

* **Atomic** — a step is written to ``step_XXXXXXXX.tmp/`` and renamed into
  place once every leaf and ``index.json`` are on disk.
* **Async** — ``save_async`` copies the tree to host memory before it
  returns and writes in a background thread.  The copy is a real one: the
  port's AdamW updates parameters in place, so a view would change under
  the writer.
* **Integrity** — every leaf records a CRC32; ``restore`` verifies it and
  falls back to the previous step on a mismatch (a torn write).

One ``.npy`` per leaf, named from the tree path (``params/layers/0/wq`` →
``params__layers__0__wq.npy``); ``index.json`` holds ``step``, ``extra``
and each leaf's ``file``, ``shape``, ``dtype`` and ``crc32``.  numpy has
no bfloat16: a bf16 leaf is written as the reference writes one, its raw
2-byte words with the dtype name ``bfloat16``, and read back as bf16.

Under a process group the files hold full leaves, as one process writes
them: every rank gathers each sharded (DTensor) leaf, rank 0 alone
writes, and ``wait`` returns on every rank once rank 0's writer is done.
``restore`` reads each leaf whole on every rank and keeps the block its
``shardings`` entry names (the reference's elastic restore), so a
checkpoint written on one mesh restores onto any other, or onto one
process without a group.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding as SH
from repro_torch import tree as TR

_STEP_RE = re.compile(r"step_(\d+)$")


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` as numpy (bf16 as its raw 2-byte words)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _from_host(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    arr = np.array(arr)                  # contiguous and writable
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


@dataclasses.dataclass
class CheckpointManager:
    directory: pathlib.Path
    keep: int = 3

    def __post_init__(self):
        self.directory = pathlib.Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Synchronous atomic save."""
        snapshot = self._snapshot(tree)
        if _writer():
            self._write(step, snapshot, extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None):
        """Copy to the host now, write in the background."""
        snapshot = self._snapshot(tree)
        self.wait()
        if _writer():
            self._thread = threading.Thread(
                target=self._write, args=(step, snapshot, extra or {}),
                daemon=True)
            self._thread.start()

    def wait(self):
        """Return once the background write is done (on every rank of a
        group)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if dist.is_initialized():
            dist.barrier()

    @staticmethod
    def _snapshot(tree: Any) -> list:
        """Host copies of the leaves, gathered whole (a collective under a
        group; only the writer keeps them)."""
        out = []
        for path, leaf in TR.flatten_with_paths(tree):
            full = SH.gather_full(leaf)
            if _writer():
                out.append((TR.path_name(path), _to_host(full)))
        return out

    def _write(self, step: int, snapshot: list, extra: dict):
        final = self.directory / f"step_{step:08d}"
        tmp = self.directory / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = {"step": step, "extra": extra, "leaves": {}}
        for name, arr in snapshot:
            fname = name.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr, allow_pickle=False)
            index["leaves"][name] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": _dtype_name(arr),
                "crc32": _crc(arr),
            }
        (tmp / "index.json").write_text(json.dumps(index))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)        # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list:
        out = []
        for p in self.directory.iterdir():
            m = _STEP_RE.search(p.name)
            if m and p.is_dir() and (p / "index.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None, device=None,
                verify: bool = True) -> tuple:
        """Restore into the structure of ``template`` (its leaves give the
        names), as tensors on ``device`` (default: the CPU); a leaf whose
        place in ``shardings`` (a tree shaped as ``template``, ``None``
        where a leaf or subtree stays whole) holds a
        :class:`repro_torch.sharding.NamedSharding` becomes this rank's
        block of it.  Falls back one step on an integrity failure."""
        candidates = ([step] if step is not None
                      else list(reversed(self.all_steps())))
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                return self._restore_step(template, s, shardings, device,
                                          verify)
            except Exception as e:      # torn checkpoint → try previous
                last_err = e
                continue
        raise FileNotFoundError(
            f"no restorable checkpoint in {self.directory}: {last_err}")

    def _restore_step(self, template, step, shardings, device, verify):
        d = self.directory / f"step_{step:08d}"
        index = json.loads((d / "index.json").read_text())
        leaves = []
        for path, _ in TR.flatten_with_paths(template):
            name = TR.path_name(path)
            meta = index["leaves"][name]
            arr = np.load(d / meta["file"], allow_pickle=False)
            if verify and _crc(arr) != meta["crc32"]:
                raise IOError(f"crc mismatch for {name} at step {step}")
            sh = _sharding_at(shardings, path)
            if sh is None:
                leaves.append(_from_host(arr, meta["dtype"], device))
            else:
                leaves.append(sh.shard(_from_host(arr, meta["dtype"], None),
                                       device))
        return TR.unflatten_like(template, leaves), index["extra"]


def _sharding_at(shardings, path: tuple):
    """The entry of ``shardings`` at ``path``; ``None`` where it (or a
    subtree above it) is ``None``."""
    node = shardings
    for k in path:
        if node is None:
            return None
        node = node[k]
    return node
