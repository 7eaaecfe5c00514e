"""Sharded checkpoints of nested dicts/lists/tuples of tensors, in the JAX
package's on-disk format (the port of ``dmlc_tpu/checkpoint/sharded.py``).

Layout under a checkpoint directory::

    manifest.json          {"format": 1, "leaves": {key: {"path", "shape",
                            "dtype", "spec", "shards", "crc32c"}}}
    <leaf-key>.<shard-id>  the shard's raw little-endian bytes

A leaf's key is JAX's ``keystr`` of its path (``['params']['embed']``,
``['opt'][0].mu[...]`` for a named tuple's field) with every character
but ``[A-Za-z0-9._-]`` made ``_`` and the ends stripped; dict keys are
visited in sorted order, as JAX flattens them.  A shard id names the
global box it covers (``0-2048_0-32768``, ``scalar``).  bfloat16 moves
as its bytes (``"bfloat16"`` in the manifest, as JAX writes it), never
through float32 or numpy.  So a checkpoint the JAX package saved
restores here and the other way round.

Without a mesh each leaf is one shard and its ``spec`` is null.  On a
mesh (``save_pytree(..., mesh=, specs=)``) the leaves are this rank's
shards and ``specs`` gives each leaf's ``PartitionSpec`` as the
reference's manifest writes it (``models.convert.state_specs``): each
rank writes the shards it holds under their global index keys, of
replicas only the rank at coordinate 0 on every live axis the leaf is
not sharded over, and rank 0 writes the manifest, with every rank's
shards and digests, after the others have written theirs (the
reference's ``save_pytree(..., process_index=)``, whose process 0 lists
its own shards only).  ``restore_pytree(..., mesh=)`` reads only the
slice this rank's coordinate needs by the manifest's spec, from the
file its index key names.

Every file goes through ``Stream.create``, so ``uri`` may be a local
path or an object store's (``gs://``, ``s3://``, ``azure://``,
``hdfs://``; ``http(s)://`` to read), as in the JAX package.

Crash consistency: shards first, the manifest last, locally through a
temp file, ``fsync`` and ``os.replace``, on an object store as one PUT
(all or nothing there); a step without a committed manifest does not
exist for restore.  Every shard carries a CRC-32C digest in the
manifest and a restore verifies it.

Telemetry, as the JAX package's: ``checkpoint.save`` and
``checkpoint.restore`` spans with their ``save``/``restore`` duration
histograms, the ``saves``, ``restores``, ``bytes_written`` and
``bytes_read`` counters, and ``integrity.checksum_failures`` with a
``checkpoint_shard_corrupt`` event per failed digest.  A save made
inside a step on the stepping thread is that step's
``checkpoint_stall_s`` in the step ledger.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import logging as log
from .. import telemetry
from ..base import DMLCError, check
from ..io.integrity import crc32c
from ..io.stream import Stream

__all__ = ["CorruptCheckpoint", "MissingLeaf", "save_pytree",
           "restore_pytree", "CheckpointManager", "leaf_key",
           "flatten_with_path"]

MANIFEST = "manifest.json"

_TORCH_DTYPES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


class CorruptCheckpoint(DMLCError):
    """A checkpoint whose manifest does not parse, or a shard that fails
    its CRC32C digest or its size."""


class MissingLeaf(DMLCError):
    """The restore template names a leaf the manifest does not carry."""


# ---------------------------------------------------------------------------
# trees: JAX's flattening order and key strings
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float))


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """``[(keystr, leaf)]`` in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted, sequences by index, named tuples by field;
    ``None`` holds no leaf."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path: str) -> None:
        if node is None:
            return
        if _is_leaf(node):
            out.append((path, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif _is_namedtuple(node):
            for name in node._fields:
                walk(getattr(node, name), f"{path}.{name}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            raise DMLCError(f"checkpoint tree node of type "
                            f"{type(node).__name__} at {path or '<root>'}")

    walk(tree, "")
    return out


def _unflatten(tree, leaves: Dict[str, Any]):
    """``tree`` with each leaf replaced by ``leaves[keystr]``."""
    def build(node, path: str):
        if node is None:
            return None
        if _is_leaf(node):
            return leaves[path]
        if isinstance(node, dict):
            return {k: build(node[k], f"{path}[{k!r}]") for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, n), f"{path}.{n}")
                                for n in node._fields))
        return type(node)(build(v, f"{path}[{i}]")
                          for i, v in enumerate(node))

    return build(tree, "")


def leaf_key(path: str) -> str:
    """The file-safe key of a leaf path (``_leaf_key`` of the JAX
    package)."""
    safe = "".join(c if (c.isalnum() or c in "._-") else "_" for c in path)
    return safe.strip("_") or "leaf"


def _index_key(shape, box=None) -> str:
    """The id of the shard covering ``box`` (``((start, stop), ...)``;
    default the whole array)."""
    if box is None:
        box = tuple((0, d) for d in shape)
    return "_".join(f"{a}-{b}" for a, b in box) if len(box) else "scalar"


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _mesh_box(shape, spec, mesh, local: bool) -> Tuple[tuple, tuple]:
    """``(global shape, this rank's box)`` of a leaf sharded by ``spec``
    on ``mesh``; ``shape`` is the local shard's (``local``) or the
    global array's."""
    glob, box = [], []
    for i, d in enumerate(shape):
        axes = _spec_axes(spec[i]) if spec and i < len(spec) else ()
        n = mesh.axis_size(axes) if axes else 1
        r = mesh.axis_rank(axes) if axes else 0
        size = d if local else d // n
        check(local or d % n == 0, f"dim {i} of {tuple(shape)} does not "
              f"split over {axes}")
        glob.append(size * n)
        box.append((r * size, (r + 1) * size))
    return tuple(glob), tuple(box)


def _writes(spec, mesh) -> bool:
    """Whether this rank writes its shard: the replica at coordinate 0 on
    every axis the leaf is not sharded over."""
    sharded = {a for e in (spec or ()) for a in _spec_axes(e)}
    return all(c == 0 for a, c in mesh.coords.items() if a not in sharded)


def _host_dtype(leaf) -> str:
    """The leaf's dtype name as the manifest writes it."""
    if isinstance(leaf, torch.Tensor):
        check(leaf.dtype in _TORCH_DTYPES,
              f"checkpoint: unsupported dtype {leaf.dtype}")
        return _TORCH_DTYPES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def _host_bytes(leaf) -> np.ndarray:
    """A uint8 view of the leaf's bytes on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        return t.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def _local_path(uri: str) -> Optional[str]:
    """The OS path of a local URI, None for an object store's."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    return None if "://" in uri else uri


def _join(base: str, name: str) -> str:
    return base.rstrip("/") + "/" + name


def _list_names(uri: str) -> Optional[List[str]]:
    """The names of the files under a checkpoint directory, listed
    through its FileSystem; None where the store cannot list (HTTP, or a
    listing that fails in the OS)."""
    from ..io.filesys import FileSystem, UnsupportedListing
    from ..io.uri import URI

    base = URI(uri)
    try:
        entries = FileSystem.get_instance(base).list_directory(base)
    except (OSError, UnsupportedListing):
        return None
    return [f.path.name.rstrip("/").rsplit("/", 1)[-1] for f in entries]


def _openable(uri: str) -> bool:
    """Whether ``uri`` opens for reading (the existence test of a store
    without local paths)."""
    s = Stream.create(uri, "r", allow_null=True)
    if s is not None:
        s.close()
    return s is not None


def _commit_manifest(uri: str, data: bytes) -> None:
    """The manifest, written last and atomically: locally a temp file,
    fsync and rename; on an object store one PUT.  Shards without a
    committed manifest are invisible to restore, so a crash mid-save
    leaves the previous step the target.  The ``checkpoint.commit`` fault
    point fires first."""
    from ..resilience import fault_point

    fault_point("checkpoint.commit", uri=uri)
    path = _local_path(_join(uri, MANIFEST))
    if path is None:
        with Stream.create(_join(uri, MANIFEST), "w") as s:
            s.write(data)
        return
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_pytree(uri: str, tree: Any, *, mesh=None,
                specs: Optional[Dict[str, Optional[list]]] = None) -> int:
    """Write ``tree`` (nested dicts/lists/tuples of tensors and arrays)
    under ``uri``; returns the bytes of shards this process wrote.
    Tensors on the card are copied to the host one leaf at a time.

    With ``mesh`` the leaves are this rank's shards, ``specs`` maps each
    leaf's path (``flatten_with_path``'s) to its spec (an axis name, a
    list of names or None per leading dim; a leaf it does not name is
    replicated), and every rank of the mesh calls this (the manifest's
    commit is collective)."""
    path = _local_path(uri)
    with telemetry.span("checkpoint.save", stage="checkpoint",
                        args={"uri": uri}), \
            telemetry.timed("checkpoint", "save"):
        nbytes = _save(uri, path, tree, mesh, specs or {})
    telemetry.inc("checkpoint", "bytes_written", nbytes)
    telemetry.inc("checkpoint", "saves")
    return nbytes


def _save(uri: str, path: Optional[str], tree: Any, mesh, specs) -> int:
    if path is not None:   # an object store has no directories to make
        os.makedirs(path, exist_ok=True)
    manifest: Dict[str, Any] = {"format": 1, "leaves": {}}
    nbytes = 0
    for kpath, leaf in flatten_with_path(tree):
        key = leaf_key(kpath)
        check(key not in manifest["leaves"], f"duplicate leaf key {key}")
        spec = specs.get(kpath)
        shape = tuple(np.shape(leaf))
        box = None
        if mesh is not None:
            shape, box = _mesh_box(shape, spec, mesh, local=True)
        entry = manifest["leaves"][key] = {
            "path": kpath, "shape": list(shape), "dtype": _host_dtype(leaf),
            "spec": spec if mesh is not None else None, "shards": {},
            "crc32c": {}}
        if mesh is not None and not _writes(spec, mesh):
            continue
        raw = _host_bytes(leaf)
        ikey = _index_key(shape, box)
        fname = f"{key}.{ikey}"
        with Stream.create(_join(uri, fname), "w") as s:
            s.write(memoryview(raw))
        nbytes += raw.size
        entry["shards"][ikey] = fname
        entry["crc32c"][ikey] = crc32c(raw)
    if mesh is not None and mesh.world > 1:
        import torch.distributed as dist

        # every rank's shards are on disk once it has sent its list; the
        # manifest goes last, and no rank returns before it is committed
        lists: List[Any] = [None] * mesh.world
        dist.all_gather_object(lists, {k: (e["shards"], e["crc32c"])
                                       for k, e in manifest["leaves"].items()})
        for other in lists:
            for k, (shards, crcs) in other.items():
                manifest["leaves"][k]["shards"].update(shards)
                manifest["leaves"][k]["crc32c"].update(crcs)
        if mesh.rank == 0:
            _commit_manifest(uri, json.dumps(manifest, indent=1).encode())
        dist.barrier()
    else:
        _commit_manifest(uri, json.dumps(manifest, indent=1).encode())
    return nbytes


def _read_file(uri: str) -> np.ndarray:
    path = _local_path(uri)
    if path is None:   # an object store's: read to the end, no stat
        buf = bytearray()
        with Stream.create(uri, "r") as s:
            while True:
                chunk = s.read(8 << 20)
                if not chunk:
                    break
                buf += chunk
        return np.frombuffer(buf, np.uint8)
    out = np.empty(os.path.getsize(path), np.uint8)
    mv = memoryview(out)
    with Stream.create(uri, "r") as s:
        got = 0
        while got < out.size:
            n = s.readinto(mv[got:])
            if n == 0:
                break
            got += n
    return out[:got]


def _try_extents(ikey: str, shape) -> Optional[tuple]:
    """((start, stop), ...) when ikey is a well-formed in-bounds shard id
    for ``shape``, else None."""
    if ikey == "scalar":
        return () if tuple(shape) == () else None
    parts = ikey.split("_")
    if len(parts) != len(shape):
        return None
    out = []
    for p, dim in zip(parts, shape):
        m = p.split("-")
        if len(m) != 2 or not (m[0].isdigit() and m[1].isdigit()):
            return None
        a, b = int(m[0]), int(m[1])
        if not (0 <= a < b <= dim):
            return None
        out.append((a, b))
    return tuple(out)


def _exact_cover(boxes, shape) -> bool:
    """True iff the shard boxes tile the array: disjoint, and their
    volume is the array's."""
    if any(b is None for b in boxes):
        return False
    vol = 0
    for b in boxes:
        v = 1
        for a, c in b:
            v *= c - a
        vol += v
    if vol != int(np.prod(shape, dtype=np.int64)):
        return False
    for i in range(len(boxes)):
        for j in range(i + 1, len(boxes)):
            if all(a1 < b2 and a2 < b1
                   for (a1, b1), (a2, b2) in zip(boxes[i], boxes[j])):
                return False
    return True


def _load_manifest(uri: str) -> Dict[str, Any]:
    raw = bytes(_read_file(_join(uri, MANIFEST)))
    try:
        manifest = json.loads(raw)
        if not isinstance(manifest, dict):
            raise ValueError("manifest is not a JSON object")
    except ValueError as e:
        raise CorruptCheckpoint(f"checkpoint manifest at {uri} is "
                                f"unparseable ({e})") from e
    if manifest.get("format") != 1:
        raise CorruptCheckpoint(f"checkpoint manifest at {uri} has unknown "
                                f"format {manifest.get('format')!r}")
    if not isinstance(manifest.get("leaves"), dict):
        raise CorruptCheckpoint(f"checkpoint manifest at {uri} lacks its "
                                "leaves table")
    return manifest


def _restore(uri: str, template: Any, mesh=None) -> Tuple[Any, int]:
    with telemetry.span("checkpoint.restore", stage="checkpoint",
                        args={"uri": uri}), \
            telemetry.timed("checkpoint", "restore"):
        out = _restore_tree(uri, template, mesh)
    telemetry.inc("checkpoint", "restores")
    return out


def _restore_tree(uri: str, template: Any, mesh=None) -> Tuple[Any, int]:
    manifest = _load_manifest(uri)
    leaves_meta = manifest["leaves"]
    local = _local_path(uri)
    listing: List[Optional[List[str]]] = []
    nread = 0

    def names() -> Optional[List[str]]:
        """The directory's file names, listed once per restore."""
        if not listing:
            listing.append(os.listdir(local) if local is not None
                           else _list_names(uri))
        return listing[0]

    def exists(fname: str) -> bool:
        if local is not None:
            return os.path.exists(_local_path(_join(uri, fname)))
        got = names()
        return fname in got if got is not None \
            else _openable(_join(uri, fname))

    def shard_bytes(key, ikey, nbytes, want_crc) -> np.ndarray:
        nonlocal nread
        # the file name is derived, not looked up: in a multi-host JAX save
        # each process writes its own shards, one writes the manifest
        raw = _read_file(_join(uri, f"{key}.{ikey}"))
        nread += raw.size
        telemetry.inc("checkpoint", "bytes_read", raw.size)
        got = crc32c(raw) if want_crc is not None else None
        if got is not None and got != int(want_crc):
            telemetry.inc("integrity", "checksum_failures")
            telemetry.record_event("checkpoint_shard_corrupt", uri=uri,
                                   shard=f"{key}.{ikey}")
            raise CorruptCheckpoint(
                f"checkpoint shard {key}.{ikey} failed its CRC32C digest "
                f"(manifest {int(want_crc):#010x}, file {got:#010x}) — "
                f"the checkpoint at {uri} is corrupt")
        if raw.size != nbytes:
            raise CorruptCheckpoint(
                f"checkpoint shard {key}.{ikey} holds {raw.size} bytes, "
                f"expected {nbytes} — the checkpoint at {uri} is corrupt")
        return raw

    def shard_ids(key, meta, shape) -> List[str]:
        """The shard ids covering the leaf: the manifest's, completed
        from the directory listing when it does not cover the array."""
        ikeys = [k for k in meta["shards"]
                 if _try_extents(k, shape) is not None]
        if _exact_cover([_try_extents(k, shape) for k in ikeys], shape):
            return ikeys
        prefix = key + "."
        extra = {n[len(prefix):] for n in names() or ()
                 if n.startswith(prefix)}
        ikeys = sorted(set(ikeys) | {k for k in extra
                                     if _try_extents(k, shape)})
        check(_exact_cover([_try_extents(k, shape) for k in ikeys], shape),
              f"checkpoint leaf {key}: shard files {ikeys} do not tile the "
              "array exactly")
        return ikeys

    def read_box(key, meta, shape, box, dtype, itemsize, crcs):
        """The leaf's ``box``: the shard file of that box, else the parts
        of the shards that cover it (a checkpoint saved with another
        layout, or a whole leaf from a sharded save)."""
        sub = tuple(b - a for a, b in box)
        ikey = _index_key(shape, box)
        if exists(f"{key}.{ikey}"):
            raw = shard_bytes(key, ikey, int(np.prod(sub, dtype=np.int64))
                              * itemsize, crcs.get(ikey))
            return torch.from_numpy(raw).view(dtype).reshape(sub)
        out_t = torch.empty(sub, dtype=dtype)
        for other in shard_ids(key, meta, shape):
            obox = _try_extents(other, shape)
            cut = [(max(a, c), min(b, d)) for (a, b), (c, d)
                   in zip(box, obox)]
            if any(a >= b for a, b in cut):
                continue
            osub = tuple(d - c for c, d in obox)
            raw = shard_bytes(key, other, int(np.prod(osub, dtype=np.int64))
                              * itemsize, crcs.get(other))
            part = torch.from_numpy(raw).view(dtype).reshape(osub)
            out_t[tuple(slice(a - x, b - x) for (a, b), (x, _)
                        in zip(cut, box))] = \
                part[tuple(slice(a - c, b - c) for (a, b), (c, _)
                           in zip(cut, obox))]
        return out_t

    out: Dict[str, Any] = {}
    for kpath, tmpl in flatten_with_path(template):
        key = leaf_key(kpath)
        meta = leaves_meta.get(key)
        if meta is None:
            raise MissingLeaf(f"checkpoint missing leaf {key}")
        shape = tuple(meta["shape"])
        dtype = _DTYPE_NAMES.get(meta["dtype"])
        check(dtype is not None,
              f"checkpoint leaf {key}: unsupported dtype {meta['dtype']}")
        itemsize = torch.empty((), dtype=dtype).element_size()
        box = tuple((0, d) for d in shape)
        if mesh is not None:   # this rank's slice by the manifest's spec
            _, box = _mesh_box(shape, meta.get("spec"), mesh, local=False)
        full = read_box(key, meta, shape, box, dtype, itemsize,
                        meta.get("crc32c") or {})
        if mesh is not None and isinstance(tmpl, torch.Tensor):
            check(tuple(tmpl.shape) == tuple(full.shape),
                  f"checkpoint leaf {key}: this rank's slice "
                  f"{tuple(full.shape)} != the template's "
                  f"{tuple(tmpl.shape)}")
        if isinstance(tmpl, (np.ndarray, np.generic)):
            check(dtype != torch.bfloat16, f"checkpoint leaf {key}: "
                  "bfloat16 restores into a tensor template, not numpy")
            full = full.numpy()
        out[kpath] = full
    return _unflatten(template, out), nread


def restore_pytree(uri: str, template: Any, *, mesh=None) -> Any:
    """The tree saved under ``uri``, shaped as ``template`` (its values
    are ignored; a ``device="meta"`` tensor template costs no memory).
    Leaves come back as CPU tensors, or numpy arrays where the template
    holds numpy.  With ``mesh`` each leaf is this rank's slice by the
    manifest's spec (the whole leaf where the spec is null), and a
    tensor template's shape must be the slice's."""
    return _restore(uri, template, mesh)[0]


class CheckpointManager:
    """Step-numbered checkpoints under ``base_uri`` with crash-consistent
    restore and retention of the newest ``max_to_keep`` committed steps.

    A step exists once its manifest is committed; ``latest_step`` and
    ``restore_latest`` scan the step directories and skip a torn one, and
    ``restore_latest`` falls back a step past a corrupt one.  The
    ``LATEST`` file is a hint, the restore pointer only where the store
    cannot be listed, and then its step's manifest must be committed.
    Retention deletes local steps only: an object store keeps every
    step.  :meth:`stats` counts saves and bytes written and read."""

    def __init__(self, base_uri: str, *, max_to_keep: int = 3):
        check(max_to_keep >= 1,
              f"max_to_keep must be >= 1, got {max_to_keep}")
        self.base = base_uri.rstrip("/")
        self.max_to_keep = max_to_keep
        self._stats = {"saves": 0, "bytes_written": 0, "bytes_read": 0}

    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def _step_dir(self, step: int) -> str:
        return f"{self.base}/step_{step:08d}"

    def save(self, step: int, tree: Any) -> None:
        self._stats["bytes_written"] += save_pytree(self._step_dir(step),
                                                    tree)
        self._stats["saves"] += 1
        with Stream.create(_join(self.base, "LATEST"), "w") as s:
            s.write(str(step).encode())
        self._retain()

    def _has_manifest(self, step: int) -> bool:
        uri = _join(self._step_dir(step), MANIFEST)
        path = _local_path(uri)
        return os.path.exists(path) if path is not None else _openable(uri)

    def _step_dirs(self) -> Optional[List[int]]:
        """Step numbers with a ``step_*`` directory (committed or not);
        None where an object store cannot be listed."""
        base = _local_path(self.base)
        if base is not None:
            names = os.listdir(base) if os.path.isdir(base) else []
        else:
            try:
                names = _list_names(self.base)
            except DMLCError as e:
                if e.status != 404:   # WebHDFS: no directory, no steps yet
                    raise
                names = []
            if names is None:
                return None
        return [int(m.group(1)) for m in
                (re.match(r"^step_(\d+)$", n) for n in names) if m]

    def _committed_steps(self) -> List[int]:
        """Committed step numbers, newest first (none where the store
        cannot be listed: :meth:`latest_step` reads the hint then)."""
        return [s for s in sorted(self._step_dirs() or (), reverse=True)
                if self._has_manifest(s)]

    def latest_step(self) -> Optional[int]:
        """The newest step with a committed manifest; where the store
        cannot be listed, the ``LATEST`` hint's step if its manifest is
        committed."""
        steps = self._step_dirs()
        if steps is None:
            s = Stream.create(_join(self.base, "LATEST"), "r",
                              allow_null=True)
            if s is None:
                return None
            with s:
                raw = s.read(64).strip()
            return int(raw) if raw and self._has_manifest(int(raw)) \
                else None
        return next((s for s in sorted(steps, reverse=True)
                     if self._has_manifest(s)), None)

    def restore_latest(self, template: Any):
        """``(step, tree)`` of the newest committed step that restores
        cleanly, falling back past steps that fail their digests or whose
        manifest is corrupt; ``(None, None)`` when there is none.  Only
        :class:`CorruptCheckpoint` falls back: read errors and template
        mismatches propagate."""
        last_err: Optional[DMLCError] = None
        candidates = self._committed_steps()
        if not candidates:
            step = self.latest_step()   # an unlistable store's hint
            if step is None:
                return None, None
            candidates = [step]
        for step in candidates:
            try:
                tree, nread = _restore(self._step_dir(step), template)
            except CorruptCheckpoint as e:
                last_err = e
                log.warning(f"checkpoint step {step} failed to restore "
                            f"({e}); falling back to the previous "
                            f"committed step")
                continue
            self._stats["bytes_read"] += nread
            return step, tree
        raise DMLCError(f"no committed checkpoint under {self.base} restored "
                        f"cleanly (last error: {last_err})")

    def _retain(self) -> None:
        if _local_path(self.base) is None:
            return   # retention is local-only: an object store keeps all
        committed = self._committed_steps()
        # the newest max_to_keep committed steps stay; a torn directory
        # never pushes a restorable step out of the window
        for old in committed[self.max_to_keep:]:
            shutil.rmtree(_local_path(self._step_dir(old)),
                          ignore_errors=True)
        # torn directories older than the newest committed step will never
        # complete; newer ones may be a save in flight
        if committed:
            for step in self._step_dirs():
                if step < committed[0] and not self._has_manifest(step):
                    shutil.rmtree(_local_path(self._step_dir(step)),
                                  ignore_errors=True)
