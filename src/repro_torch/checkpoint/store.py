"""On-disk checkpoint store with atomic commit, on the port's devices.

The files are the reference's (``repro/checkpoint/store.py``), byte for
byte, so a step written by either store restores in the other:

    <root>/step_000123.tmp-<nonce>/      (staging, renamed on commit)
    <root>/step_000123/
        manifest.json     tree structure, shapes, dtypes, crc32 per leaf,
                          codec info
        manifest.crc      crc32 of manifest.json
        <leaf-key>.npy    raw (or codec-encoded) array payloads

Properties, as in the reference:

* **Atomic commit**: payloads land in a staging directory; ``os.replace``
  to the final name is the commit point.  Payloads, manifest and sidecar
  are fsync'd before the rename and the parent directory after it.
* **Integrity**: per-leaf crc32 checked on restore; ``restore_latest``
  walks committed steps newest-first and skips torn or corrupt ones with
  a ``RuntimeWarning``.
* **Codec on the device**: with ``codec="int8"`` or ``"int8_delta"``, f32
  and f16 leaves of at least 1024 elements are encoded where they lie,
  through :mod:`repro_torch.kernels.ops` (the CUDA kernels on the card),
  and only the codes and scales cross to the host.

A save is two halves: :meth:`CheckpointStore.snapshot` (device side:
encode and copy to host memory) and :meth:`CheckpointStore.write` (host
side: files, fsync, commit); :class:`~.async_ckpt.AsyncCheckpointer` runs
the second half on a thread.  Restores land on the devices of a target
tree, or on ``device`` (CUDA unless the caller asks for the CPU).

Trees are nested dicts, lists, tuples and NamedTuples of tensors (numpy
arrays are taken too).  Leaf keys follow ``jax.tree_util``: dict keys
sorted, sequence entries by index, a NamedTuple's fields as ``.<name>``
(the AdamW state's ``opt/.step``, ``opt/.moments/...``), joined with
``/``; ``None`` holds no leaf.

**bfloat16 leaves** (Jamba's parameters) are stored raw under every codec,
as the reference's codec takes only f32 / f16.  numpy has no bfloat16, so
the leaf is copied to the host as its int16 bit pattern and written with
the header the reference's ``np.save`` of an ``ml_dtypes`` bfloat16 array
writes (``'descr': '<V2'``): the same bytes, the same crc and the manifest
dtype ``"bfloat16"``.  A restore reads the two-byte records back as
bfloat16 by the manifest's dtype.  The reference's own restore cannot read
such a file into a target (its ``astype`` has no cast from ``V2``); the
port's reads the reference's files and its own.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
import warnings
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.torch_sim import resolve_device
from ..kernels import ops
from ..kernels.ckpt_codec import BLOCK

__all__ = [
    "CheckpointStore", "Snapshot", "latest_step", "map_with_keys",
    "flatten_with_keys", "encode_leaf", "decode_leaf",
]

_CODEC_DTYPES = (torch.float32, torch.float16)
_CODEC_MIN_SIZE = 1024


# --------------------------------------------------------------------------- #
# Trees
# --------------------------------------------------------------------------- #
def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def map_with_keys(fn: Callable[[str, Any], Any], tree, _prefix: Tuple[str, ...] = ()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``, leaves
    visited in ``jax.tree_util`` order (dict keys sorted, sequences by
    index, a NamedTuple's fields in declaration order); the returned
    dicts hold their keys in that order.  A NamedTuple is rebuilt as its
    own type, its fields keyed ``.<name>`` as ``jax.tree_util``'s
    ``GetAttrKey`` prints them (``opt/.step``)."""
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, tree[k], _prefix + (str(k),)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(
            map_with_keys(fn, v, _prefix + ("." + name,))
            for name, v in zip(type(tree)._fields, tree)
        ))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_with_keys(fn, v, _prefix + (str(i),)) for i, v in enumerate(tree)
        )
    if tree is None:
        return None
    return fn("/".join(_prefix), tree)


def flatten_with_keys(tree) -> Dict[str, Any]:
    """Leaves by path key, in ``jax.tree_util`` order."""
    flat: Dict[str, Any] = {}
    map_with_keys(flat.__setitem__, tree)
    return flat


def _tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


_BF16 = "bfloat16"
#: the ``.npy`` header field of a bfloat16 leaf, as ``np.save`` writes it
#: for an ``ml_dtypes`` bfloat16 array
_BF16_DESCR = "<V2"


def _np_dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``"float32"``; ``"bfloat16"``, the
    name ``ml_dtypes`` gives it), as the manifest records it."""
    if dtype == torch.bfloat16:
        return _BF16
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def _torch_dtype(name: str) -> torch.dtype:
    if name == _BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=name)).dtype


def _host_copy(x: torch.Tensor) -> np.ndarray:
    """A C-ordered host copy of a leaf (a bfloat16 leaf's int16 bits)."""
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.to("cpu", copy=True, memory_format=torch.contiguous_format).numpy()


def _save_npy(f, a: np.ndarray, dtype: str) -> None:
    """``np.save`` of a payload; a bfloat16 leaf's int16 bits under the
    reference's ``'<V2'`` header."""
    if dtype != _BF16:
        np.save(f, a, allow_pickle=False)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": a.shape})
    f.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8).data)


def _from_payload(payload: np.ndarray, dtype: str) -> torch.Tensor:
    """A raw payload as a CPU tensor: two-byte records (the reference's
    ``V2`` or the port's int16 bits) as bfloat16 when the manifest says
    so."""
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(payload).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(payload)


def _crc(a: np.ndarray) -> int:
    """crc32 of the array's bytes (``zlib.crc32(a.tobytes())`` without the
    copy)."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


# --------------------------------------------------------------------------- #
# Leaf codec on the leaf's device
# --------------------------------------------------------------------------- #
def encode_leaf(x, prev=None) -> Tuple[np.ndarray, Dict]:
    """:func:`repro_torch.checkpoint.codec.encode_array` of a leaf on its
    own device: the codes and scales are made there (by the kernel on the
    card) and copied into one host ``uint8`` payload, ``concat(q bytes,
    scale bytes)``.  ``prev`` of the leaf's shape selects the delta codec."""
    x = _tensor(x)
    mode = "int8"
    p = None
    if prev is not None and tuple(prev.shape) == tuple(x.shape):
        p = _tensor(prev).to(x.device)
        mode = "int8_delta"
    q, s, n = ops.quantize_checkpoint(x, p)
    nb = s.shape[0]
    payload = np.empty(nb * (BLOCK + 4), np.uint8)
    torch.from_numpy(payload[: nb * BLOCK]).copy_(q.view(-1).view(torch.uint8))
    torch.from_numpy(payload[nb * BLOCK :]).copy_(s.view(-1).view(torch.uint8))
    meta = {
        "codec": mode,
        "dtype": _np_dtype_name(x.dtype),
        "shape": list(x.shape),
        "n": int(n),
        "nblocks": int(nb),
    }
    return payload, meta


def decode_leaf(payload: np.ndarray, meta: Dict, prev=None, device="cuda") -> torch.Tensor:
    """The leaf a manifest entry and its payload hold, on ``device``:
    :func:`repro_torch.checkpoint.codec.decode_array` there (by the kernel
    on the card), or the raw array moved there."""
    if meta["codec"] == "raw":
        return _from_payload(payload, meta["dtype"]).to(device)
    nb = meta["nblocks"]
    qn = nb * BLOCK
    q = torch.from_numpy(payload[:qn].view(np.int8)).to(device).view(nb, BLOCK)
    s = torch.from_numpy(payload[qn : qn + 4 * nb].view(np.float32)).to(device).view(nb, 1)
    p = None
    if meta["codec"] == "int8_delta":
        if prev is None:
            raise ValueError("int8_delta payload needs the previous checkpoint")
        p = _tensor(prev).to(device)
    x = ops.dequantize_checkpoint(q, s, meta["n"], meta["shape"], p)
    return x.to(_torch_dtype(meta["dtype"]))


# --------------------------------------------------------------------------- #
# Durable writes
# --------------------------------------------------------------------------- #
def _write_durable(path: str, writer) -> None:
    """Write via ``writer(file)`` and fsync before returning: bytes are
    on the platter (or the journal) before the commit rename can make
    the checkpoint visible."""
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Persist a directory entry (the rename itself) — best-effort on
    filesystems without O_DIRECTORY fsync support."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - exotic fs
        pass
    finally:
        os.close(fd)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp") and "tmp-" not in d:
            try:
                steps.append(int(d.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return max(steps) if steps else None


def _blocker(shardings):
    """``(key, full leaf) -> this rank's block`` under ``shardings`` (one
    NamedSharding or a tree of them; the leaf itself without)."""
    if shardings is None:
        return lambda key, x: x
    from ..parallel.sharding import NamedSharding, local_block

    flat = None if isinstance(shardings, NamedSharding) else flatten_with_keys(shardings)

    def blocked(key, x):
        sh = shardings if flat is None else flat.get(key)
        return x if sh is None else local_block(x, sh).clone()

    return blocked


@dataclass
class Snapshot:
    """The device half of a save: per leaf key, the host array ``np.save``
    writes (a codec payload or the raw leaf) and its manifest entry
    without the crc, in tree order."""

    leaves: Dict[str, Tuple[np.ndarray, Dict]]
    raw_bytes: int
    t_snapshot: float


@dataclass
class CheckpointStore:
    root: str
    codec: str = "raw"  # raw | int8 | int8_delta
    #: leaf keys it accepts are stored raw under every codec
    raw_keys: Optional[Callable[[str], bool]] = None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    # ------------------------------------------------------------------ #
    def snapshot(self, tree, prev_tree=None) -> Snapshot:
        """Encode every codec leaf on its device and copy every leaf to
        host memory.  Returns when the copies are done, so the caller may
        change the tree after it."""
        t0 = time.monotonic()
        prev_flat = flatten_with_keys(prev_tree) if prev_tree is not None else {}
        leaves: Dict[str, Tuple[np.ndarray, Dict]] = {}
        raw_bytes = 0
        for key, leaf in flatten_with_keys(tree).items():
            x = _tensor(leaf)
            raw_bytes += x.numel() * x.element_size()
            if (self.codec != "raw" and x.dtype in _CODEC_DTYPES
                    and x.numel() >= _CODEC_MIN_SIZE
                    and not (self.raw_keys is not None and self.raw_keys(key))):
                prev = prev_flat.get(key) if self.codec == "int8_delta" else None
                leaves[key] = encode_leaf(x, prev)
            else:
                meta = {"codec": "raw", "dtype": _np_dtype_name(x.dtype),
                        "shape": list(x.shape)}
                leaves[key] = (_host_copy(x), meta)
        return Snapshot(leaves, raw_bytes, time.monotonic() - t0)

    def write(self, step: int, snap: Snapshot) -> Dict[str, float]:
        """Write a snapshot as step ``step``: staging directory, fsync,
        atomic rename.  Returns the save's timing and byte metrics."""
        t0 = time.monotonic()
        os.makedirs(self.root, exist_ok=True)
        tmp = self._dir(step) + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "codec": self.codec, "leaves": {}}
        stored_bytes = 0
        for key, (arr, meta) in snap.leaves.items():
            fname = key.replace("/", "__") + ".npy"
            _write_durable(
                os.path.join(tmp, fname),
                lambda f, a=arr, dt=meta["dtype"]: _save_npy(f, a, dt),
            )
            manifest["leaves"][key] = dict(meta, crc=_crc(arr))
            stored_bytes += arr.nbytes
        mbytes = json.dumps(manifest).encode("utf-8")
        _write_durable(
            os.path.join(tmp, "manifest.json"), lambda f: f.write(mbytes)
        )
        # checksum sidecar: lets restore_latest reject a manifest whose
        # own bytes rotted without parsing garbage JSON first
        _write_durable(
            os.path.join(tmp, "manifest.crc"),
            lambda f: f.write(f"{zlib.crc32(mbytes):08x}".encode()),
        )
        final = self._dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # commit point
        _fsync_dir(self.root)
        return {
            "t_snapshot": snap.t_snapshot,
            "t_total": snap.t_snapshot + (time.monotonic() - t0),
            "raw_bytes": float(snap.raw_bytes),
            "stored_bytes": float(stored_bytes),
        }

    def save(self, step: int, tree, prev_tree=None, shardings=None) -> Optional[Dict[str, float]]:
        """Blocking save: :meth:`snapshot` then :meth:`write`.  Returns
        timing/byte metrics.

        With ``shardings`` (a :class:`..parallel.sharding.NamedSharding`
        for every leaf, or a tree of them), ``tree`` and ``prev_tree`` hold
        this rank's blocks: every leaf is all-gathered over the mesh (a
        collective: every rank calls ``save``), rank 0 writes the full
        leaves, so the files are those of an unsharded save, and the ranks
        meet at a barrier after the commit.  Ranks other than 0 return
        ``None``."""
        if shardings is None:
            return self.write(step, self.snapshot(tree, prev_tree))
        import torch.distributed as dist

        from ..parallel.sharding import gather_tree

        tree = gather_tree(tree, shardings)
        if prev_tree is not None:
            prev_tree = gather_tree(prev_tree, shardings)
        try:
            if dist.get_rank() == 0:
                return self.write(step, self.snapshot(tree, prev_tree))
            return None
        finally:
            dist.barrier()

    # ------------------------------------------------------------------ #
    def restore(self, step: int, target=None, prev_tree=None, device=None, shardings=None):
        """Restore ``step``.  With ``target`` (a tree of tensors), each leaf
        is decoded on its target leaf's device, cast to its dtype, and the
        target's structure is returned; without, a flat ``{key: tensor}``
        on ``device`` (the current CUDA device unless the caller passes
        ``"cpu"``; without CUDA and without a device it raises).

        ``shardings`` (one :class:`..parallel.sharding.NamedSharding` for
        every leaf, or a tree of them keyed as the checkpoint) re-shards
        onto a mesh: each leaf is decoded whole and this rank keeps its
        block (``target``, if given, holds blocks).  Any mesh whose blocks
        divide the leaves will do, so a step written from a 2 x 2 mesh
        restores onto 1 x 2 or onto one rank.  ``prev_tree`` is the full
        previous tree."""
        default = resolve_device(device) if target is None else None
        blocked = _blocker(shardings)
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json"), "rb") as f:
            mbytes = f.read()
        crc_path = os.path.join(d, "manifest.crc")
        if os.path.exists(crc_path):  # sidecar absent on legacy checkpoints
            with open(crc_path) as f:
                want = f.read().strip()
            if f"{zlib.crc32(mbytes):08x}" != want:
                raise IOError(f"manifest corruption at step {step}")
        manifest = json.loads(mbytes.decode("utf-8"))
        prev_flat = flatten_with_keys(prev_tree) if prev_tree is not None else {}
        flat_target = flatten_with_keys(target) if target is not None else None

        out: Dict[str, torch.Tensor] = {}
        for key, meta in manifest["leaves"].items():
            fname = key.replace("/", "__") + ".npy"
            payload = np.load(os.path.join(d, fname), allow_pickle=False)
            if _crc(payload) != meta["crc"]:
                raise IOError(f"checkpoint corruption in {key} at step {step}")
            if flat_target is None:
                out[key] = blocked(key, decode_leaf(payload, meta, prev_flat.get(key), default))
            elif key in flat_target:
                ref = flat_target[key]
                x = decode_leaf(payload, meta, prev_flat.get(key), ref.device)
                out[key] = blocked(key, x).to(ref.dtype)

        if flat_target is None:
            return out
        missing = set(flat_target) - set(out)
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")
        return map_with_keys(lambda k, _: out[k], target)

    def steps(self) -> List[int]:
        """Committed step numbers, ascending (staging dirs excluded)."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and "tmp-" not in d:
                try:
                    out.append(int(d.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def restore_latest(
        self, target=None, prev_tree=None, device=None, shardings=None
    ) -> Optional[Tuple[int, Any]]:
        """Restore the newest checkpoint that passes integrity checks.

        Walks committed steps newest-first; a torn or corrupt one
        (truncated ``.npy`` shard, crc mismatch, missing or rotted
        manifest, missing leaves) is *skipped with a warning* instead of
        aborting the restore — the previous durable checkpoint is the
        restore point, exactly the risk the paper's recovery term
        already prices.  Returns ``(step, tree)`` or ``None`` if no
        checkpoint survives."""
        for step in reversed(self.steps()):
            try:
                tree = self.restore(
                    step, target=target, prev_tree=prev_tree, device=device,
                    shardings=shardings,
                )
                return step, tree
            except (IOError, OSError, ValueError, KeyError, EOFError,
                    json.JSONDecodeError) as e:
                warnings.warn(
                    f"skipping unusable checkpoint step {step}: {e}",
                    RuntimeWarning,
                    stacklevel=2,
                )
        return None

    def gc(self, keep: int = 2) -> None:
        """Drop all but the newest ``keep`` committed checkpoints."""
        for s in self.steps()[:-keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
