"""Transparent, consistent, content-deduplicated checkpointing (§4, §4.6)
(port of ``repro.core.checkpoint``).

The checkpoint of an N-worker job is ``S_G + N * S_pwCr`` (paper §7.2):

- ``S_G``  — device state.  Per-buffer content checksums dedup identical
  buffers ACROSS workers: data-parallel replicas share identical parameter
  and optimizer tensors, so the stored device bytes are independent of the
  DP degree (Table 4's key property).
- ``S_Cr`` — per-worker host program state (CRIU analogue): the step
  counter, the data cursor, the world size and rank.  Chunk-level content
  addressing gives the paper's page-dedup across workers, and TEMPORAL
  dedup makes incremental snapshots smaller than the first one.

Chunks are content-addressed (blake2b-128 of 1 MiB chunks); a snapshot is
a manifest of chunk references.  The store can live in memory or on disk.

The store holds host arrays: a leaf's bytes are ``np.save`` of the numpy
leaf, as in the JAX package, and the runtime's tensors come to the host
through ``bridge.train_state_to_numpy`` (``ElasticRuntime.snapshot``).  A
manifest lists each worker's leaves in ``jax.tree_util``'s order (sorted
keys, ``None`` dropped), so the two packages give the same chunk refs for
the same state.  Where the JAX manifest keeps the pickled treedef, which
only jaxlib can read, the port's keeps the leaves' key paths
(``utils.tree.tree_spec``) and never unpickles a treedef: a manifest that
the JAX package wrote restores with a template tree (``like=``).
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.utils.hashing import chunk_checksums
from repro_torch.utils.tree import (tree_flatten, tree_from_spec, tree_spec,
                                    tree_unflatten_sorted)

CHUNK = 1 << 20     # 1 MiB content chunks (page-dedup granularity)


def _leaf_bytes(leaf) -> bytes:
    arr = np.asarray(leaf)
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _leaf_from_bytes(b: bytes):
    return np.load(io.BytesIO(b), allow_pickle=False)


@dataclasses.dataclass
class SnapshotStats:
    step: int
    device_logical_bytes: int      # sum over all workers (no dedup)
    device_stored_bytes: int       # unique bytes actually stored (S_G)
    host_logical_bytes: int        # sum of per-worker host dumps
    host_stored_bytes: int         # unique new chunks stored this snapshot
    n_workers: int
    wall_seconds: float


class CheckpointStore:
    """Content-addressed chunk store + snapshot manifests.

    With a ``root``, chunks go to ``root/chunks/<checksum>`` and each job's
    manifests to ``root/<job>.manifests.json``; a store opened later on the
    same root reads both back.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root
        self.chunks: Dict[str, bytes] = {}
        self.manifests: Dict[str, List[Dict]] = {}     # job -> snapshots
        if root:
            os.makedirs(os.path.join(root, "chunks"), exist_ok=True)

    # ---------------------------------------------------------------- chunks
    def _put_chunk(self, data: bytes) -> Tuple[str, bool]:
        if len(data) > CHUNK:
            raise ValueError("chunk too large")
        cs = chunk_checksums(data, len(data) or 1)[0]
        new = cs not in self.chunks
        if new:
            self.chunks[cs] = data
            if self.root:
                with open(os.path.join(self.root, "chunks", cs), "wb") as f:
                    f.write(data)
        return cs, new

    def _get_chunk(self, cs: str) -> bytes:
        if cs in self.chunks:
            return self.chunks[cs]
        if self.root:
            with open(os.path.join(self.root, "chunks", cs), "rb") as f:
                data = f.read()
            self.chunks[cs] = data
            return data
        raise KeyError(cs)

    def _put_blob(self, data: bytes) -> Tuple[List[str], int]:
        """Store a blob as content chunks; returns (chunk refs, new bytes)."""
        refs, new_bytes = [], 0
        for i in range(0, max(len(data), 1), CHUNK):
            piece = data[i:i + CHUNK]
            cs, new = self._put_chunk(piece)
            refs.append(cs)
            if new:
                new_bytes += len(piece)
        return refs, new_bytes

    def _get_blob(self, refs: List[str]) -> bytes:
        return b"".join(self._get_chunk(c) for c in refs)

    def _manifest_path(self, job_id: str) -> str:
        return os.path.join(self.root, f"{job_id}.manifests.json")

    # -------------------------------------------------------------- snapshot
    def snapshot(self, job_id: str, step: int,
                 device_state_by_worker: Dict[int, Any],
                 host_state_by_worker: Dict[int, Dict],
                 files_by_worker: Optional[Dict[int, Dict[str, bytes]]] = None
                 ) -> SnapshotStats:
        """Take a consistent checkpoint.

        device_state_by_worker: worker -> tree (str-keyed dicts) of host
                                arrays (P, O, ...).
        host_state_by_worker:   worker -> picklable host program state.
        files_by_worker:        worker -> {path: content} mutated local files
                                (tracked by the libc SA_Int, §4.4); deduped
                                by content checksum across workers.
        """
        t0 = time.time()
        manifest: Dict = {"job": job_id, "step": step, "workers": {}}
        dev_logical = dev_stored = host_logical = host_stored = 0

        for w, tree in device_state_by_worker.items():
            leaves, _ = tree_flatten(tree)
            entries = []
            for leaf in leaves:
                data = _leaf_bytes(leaf)
                dev_logical += len(data)
                refs, new = self._put_blob(data)
                dev_stored += new
                entries.append(refs)
            entry = manifest["workers"].setdefault(str(w), {})
            entry["device"] = entries
            entry["structure"] = tree_spec(tree)

        for w, host in host_state_by_worker.items():
            data = pickle.dumps(host)
            host_logical += len(data)
            refs, new = self._put_blob(data)
            host_stored += new
            manifest["workers"].setdefault(str(w), {})["host"] = refs

        if files_by_worker:
            for w, files in files_by_worker.items():
                fl = {}
                for path, content in files.items():
                    refs, new = self._put_blob(content)
                    host_stored += new
                    fl[path] = refs
                manifest["workers"].setdefault(str(w), {})["files"] = fl

        self.manifests.setdefault(job_id, []).append(manifest)
        if self.root:
            with open(self._manifest_path(job_id), "w") as f:
                json.dump(self.manifests[job_id], f, default=str)
        return SnapshotStats(
            step=step, device_logical_bytes=dev_logical,
            device_stored_bytes=dev_stored, host_logical_bytes=host_logical,
            host_stored_bytes=host_stored,
            n_workers=len(device_state_by_worker),
            wall_seconds=time.time() - t0)

    # --------------------------------------------------------------- restore
    def _snapshots(self, job_id: str) -> List[Dict]:
        if job_id not in self.manifests and self.root and \
                os.path.exists(self._manifest_path(job_id)):
            with open(self._manifest_path(job_id)) as f:
                self.manifests[job_id] = json.load(f)
        return self.manifests[job_id]

    def _device_tree(self, entry: Dict, like: Any) -> Any:
        leaves = [_leaf_from_bytes(self._get_blob(refs))
                  for refs in entry["device"]]
        if like is None:
            if "structure" not in entry:
                raise ValueError(
                    "this manifest was written by the JAX package: its "
                    "structure is a pickled treedef, which the port does "
                    "not read; pass like=<a tree of the state's structure>")
            like = tree_from_spec(entry["structure"])
        template, _ = tree_flatten(like)
        for t, leaf in zip(template, leaves):
            if hasattr(t, "shape") and tuple(t.shape) != leaf.shape:
                raise ValueError(f"a stored leaf of shape {leaf.shape} "
                                 f"does not fit the template's "
                                 f"{tuple(t.shape)}")
        return tree_unflatten_sorted(like, leaves)

    def restore(self, job_id: str, step: Optional[int] = None, *,
                like: Any = None
                ) -> Tuple[Dict[int, Any], Dict[int, Dict], int]:
        """Returns (device_state_by_worker, host_state_by_worker, step).

        Each device tree has the structure recorded in the manifest, its
        leaves numpy arrays.  ``like``, a tree of the state's structure
        (any leaves; those with a ``shape`` must match), gives the structure
        instead: a manifest written by the JAX package needs it.
        """
        snaps = self._snapshots(job_id)
        manifest = snaps[-1] if step is None else \
            next(m for m in snaps if m["step"] == step)
        device, host = {}, {}
        for w, entry in manifest["workers"].items():
            device[int(w)] = self._device_tree(entry, like)
            host[int(w)] = pickle.loads(self._get_blob(entry["host"]))
        return device, host, manifest["step"]

    # ----------------------------------------------------------------- sizes
    def stored_bytes(self) -> int:
        return sum(len(v) for v in self.chunks.values())
