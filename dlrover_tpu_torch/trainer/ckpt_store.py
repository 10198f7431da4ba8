"""Checkpoint storage: the safe archive format and the object-store
persist tier, for trees of torch tensors.

Counterpart of ``dlrover_tpu/trainer/ckpt_store.py``, which the flash
checkpointer (``trainer/checkpoint.py``) delegates two concerns to:

1. **Archive codec** -- :func:`snapshot_to_file` /
   :func:`snapshot_from_file` write and read a state tree as a zip of
   ``.npy`` members plus a JSON ``manifest.json`` (format version 2),
   loaded back with ``numpy.load(allow_pickle=False)``: no pickle, a
   malformed archive raises :class:`ArchiveError` and nothing is ever
   executed. The tree is nested dicts, lists and tuples; a tensor leaf is
   written as a one-shard ``"shards"`` entry, as the JAX writer writes an
   array held by one device, under the same key-path components
   (``{"t": "dict", "k": ...}``, ``{"t": "seq", "i": ...}``), with dict
   keys in sorted order as ``jax.tree_util`` walks them. bfloat16 has no
   numpy dtype here: its members are raw bytes with
   ``encodings[name] = {"dtype": "bfloat16", "shape": [...]}``, as the
   JAX writer stores them, and read back through a torch dtype view.
   Every member carries its sha256 in ``digests``; a reader verifies
   before it trusts the content. The two packages read each other's
   archives.

2. **Object-store semantics** -- ``ObjectStore`` exposes put/get/list
   (flat keys, NO rename), which is what a bucket offers; the persist
   tier's atomicity comes from a COMMIT marker written *after* the data
   object:

       <prefix>/step-<N>/proc-<P>.a<attempt>.ckpt   the process's archive
       <prefix>/step-<N>/COMMIT          JSON {"step": N, "attempt": ..}

   A step without its COMMIT object is invisible to readers.
   `LocalFsStore` keeps the same layout on a directory (a shared mount).
   The JAX package's ``GcsStore`` needs ``google-cloud-storage``, and
   its multi-process commit (a barrier on every process's shard, a
   merged step manifest) comes with the multi-process slice; neither is
   ported yet (ROADMAP.md, queue A).
"""

import contextlib
import hashlib
import io
import json
import os
import queue
import shutil
import struct
import threading
import time
import zipfile
import zlib
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint import manifest as ckpt_manifest

__all__ = [
    "ArchiveError",
    "DigestMismatchError",
    "ObjectStore",
    "LocalFsStore",
    "get_store",
    "flatten_with_path",
    "snapshot_to_file",
    "snapshot_from_file",
    "read_manifest",
]

#: chunk size for streaming copies between files and object stores
_STREAM_CHUNK = 1 << 20


class ArchiveError(ValueError):
    """A checkpoint archive failed validation; never executed."""


class DigestMismatchError(ArchiveError):
    """An archive member's content hash differs from the sha256 the
    writer recorded in the manifest: silent corruption (torn object,
    bit rot, truncated upload). Restore treats the candidate as
    unusable and walks down to an older step."""


# --------------------------------------------------------------------------
# dtypes and tree paths
# --------------------------------------------------------------------------

#: torch dtype <-> the dtype name the JAX writer records; bfloat16 is the
#: one without a numpy dtype, so it travels as raw bytes + an encoding
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_TORCH_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}
_RAW = ("bfloat16",)


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise ArchiveError(f"unsupported checkpoint dtype {dtype}")


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ArchiveError(f"archive uses unavailable dtype {name!r}")


def flatten_with_path(tree) -> List[Tuple[List[Dict[str, Any]], Any]]:
    """``(path components, leaf)`` for every leaf of a tree of nested
    dicts, lists and tuples, in ``jax.tree_util``'s order (dict keys
    sorted), with the components the JAX writer records for the same
    key path."""
    out: List[Tuple[List[Dict[str, Any]], Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [{"t": "dict", "k": k}])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [{"t": "seq", "i": i}])
        else:
            out.append((path, node))

    walk(tree, [])
    return out


def unflatten_like(target, leaves: List[Any]):
    """``target``'s structure with ``leaves`` in
    :func:`flatten_with_path` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(target)


def _path_json(comps) -> str:
    return json.dumps(comps, separators=(",", ":"))


def host_bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as the numpy array the JAX writer would serialize:
    the array itself, or its raw bytes (1-D uint8) for bfloat16 --
    without a copy where the tensor is contiguous."""
    t = t.detach()
    if t.device.type != "cpu":
        raise ArchiveError(f"checkpoint leaf on {t.device}, not staged")
    t = t.contiguous()
    if dtype_name(t.dtype) in _RAW:
        return t.reshape(-1).view(torch.uint8).numpy()
    return t.numpy()


# --------------------------------------------------------------------------
# archive codec
# --------------------------------------------------------------------------

_MANIFEST = "manifest.json"
#: version 2 = the sharded checkpoint plane (format v2 of the JAX
#: package): normalized shard domains with replica sets and owners
_FORMAT_VERSION = 2
_SUPPORTED_VERSIONS = (1, 2)


_NPY_MAGIC = b"\x93NUMPY"
#: digits numpy's writer leaves room for in the first axis of a header
_GROWTH_AXIS_MAX_DIGITS = 21
#: threads that checksum, hash and copy archive members side by side
#: (zlib, hashlib and file I/O release the GIL on large buffers)
_WORKERS = max(1, min(8, os.cpu_count() or 1))


def _npy_header(arr: np.ndarray) -> bytes:
    """The .npy header of ``arr`` as ``numpy.lib.format.write_array``
    writes it: the dict of ``header_data_from_array_1_0`` with sorted
    keys, spare room to grow the first axis in place, padded to a
    64-byte boundary, format version 1.0 (2.0 past 64 KiB)."""
    d = np.lib.format.header_data_from_array_1_0(arr)
    text = "{" + "".join(f"'{k}': {v!r}, " for k, v in sorted(d.items()))
    text += "}"
    if d["shape"]:
        text += " " * (_GROWTH_AXIS_MAX_DIGITS - len(repr(d["shape"][0])))
    body = text.encode("latin1")
    for version, fmt in (((1, 0), "<H"), ((2, 0), "<I")):
        fixed = len(_NPY_MAGIC) + 2 + struct.calcsize(fmt)
        pad = -(fixed + len(body) + 1) % 64
        size = len(body) + pad + 1
        if size < 1 << (8 * struct.calcsize(fmt)):
            return (_NPY_MAGIC + bytes(version) + struct.pack(fmt, size)
                    + body + b" " * pad + b"\n")
    raise ArchiveError("array header too large")


def _member_bytes(arr: np.ndarray) -> Tuple[bytes, memoryview]:
    """(npy header, data): the member's serialized bytes, the data
    without a copy."""
    if arr.dtype.hasobject:
        raise ArchiveError("object arrays are never checkpointed")
    arr = np.ascontiguousarray(arr) if arr.ndim else arr.reshape(())
    return _npy_header(arr), memoryview(arr.reshape(-1)).cast("B")


def _digest_and_crc(header: bytes, data: memoryview) -> Tuple[str, int]:
    digest = hashlib.sha256(header)
    digest.update(data)
    return digest.hexdigest(), zlib.crc32(data, zlib.crc32(header))


def _write_members(zf: zipfile.ZipFile, fileobj, members) -> Dict[str, str]:
    """Write ``[(name, header, data)]`` as stored zip members, the way
    ``ZipFile.open(name, "w", force_zip64=True)`` lays them out, and
    return their sha256 digests. On a real file the members' CRC-32s and
    digests are computed and their bytes written by several threads,
    each at its member's precomputed offset; elsewhere one after another."""
    when = time.localtime(time.time())[:6]
    infos, offset = [], zf.fp.tell()
    for name, header, data in members:
        zinfo = zipfile.ZipInfo(name, date_time=when)
        zinfo.compress_type = zipfile.ZIP_STORED
        zinfo.external_attr = 0o600 << 16
        zinfo.file_size = zinfo.compress_size = len(header) + data.nbytes
        zinfo.CRC = 0  # until computed; the header's length is the same
        zinfo.header_offset = offset
        offset += len(zinfo.FileHeader(True)) + zinfo.file_size
        infos.append(zinfo)
    try:
        fd = fileobj.fileno()
    except (AttributeError, OSError, io.UnsupportedOperation):
        fd = None

    def one(i):
        name, header, data = members[i]
        digest, infos[i].CRC = _digest_and_crc(header, data)
        if fd is not None:
            pos = infos[i].header_offset + len(infos[i].FileHeader(True))
            for part in (header, data):
                view = memoryview(part)
                while view.nbytes:
                    n = os.pwrite(fd, view, pos)
                    pos += n
                    view = view[n:]
        return digest

    if fd is not None:
        fileobj.flush()
        with ThreadPoolExecutor(_WORKERS) as pool:
            digests = list(pool.map(one, range(len(members))))
        for zinfo in infos:
            os.pwrite(fd, zinfo.FileHeader(True), zinfo.header_offset)
        fileobj.seek(offset)
    else:
        digests = [one(i) for i in range(len(members))]
        for zinfo, (_, header, data) in zip(infos, members):
            fileobj.write(zinfo.FileHeader(True))
            fileobj.write(header)
            fileobj.write(data)
    # the members join the central directory that close() writes
    for zinfo in infos:
        zf.filelist.append(zinfo)
        zf.NameToInfo[zinfo.filename] = zinfo
    zf.start_dir = offset
    zf._didModify = True
    return {name: d for (name, _, _), d in zip(members, digests)}


def snapshot_to_file(snapshot: Any, step: int, fileobj: BinaryIO,
                     last_good: Optional[bool] = None,
                     topology: Optional[Dict[str, int]] = None) -> int:
    """Write a state tree to ``fileobj`` as a safe archive; returns the
    bytes written (-1 if the file can't tell()).

    Leaves: CPU torch tensors (one ``"shards"`` entry each, covering the
    whole tensor), numpy arrays (``"array"``), or JSON primitives
    (``"py"``); anything else raises ArchiveError at save time. Members
    are written from the leaves' memory without a copy. ``last_good``
    is the sentinel's verdict at save time, written to the manifest when
    not None (False: saved inside an anomaly window). ``topology``
    (``{"n_processes": 1, "process_index": 0}``) stamps the save
    topology into the manifest; the owned-only subsets of a
    multi-process save come with the distributed slice.
    """
    me = int(topology["process_index"]) if topology else 0
    manifest: Dict[str, Any] = {
        "version": _FORMAT_VERSION,
        "step": int(step),
        "leaves": [],
        # bfloat16 round-trips as raw bytes + a recorded dtype name
        "encodings": {},
        # member name -> sha256 of its serialized bytes
        "digests": {},
    }
    if last_good is not None:
        # sentinel verdict at save time (fault_tolerance/sentinel.py):
        # False = this save happened inside an anomaly window and the
        # restore walk-down must skip it. Absent (older archives, or no
        # sentinel armed) is treated as clean.
        manifest["last_good"] = bool(last_good)
    if topology is not None:
        manifest["topology"] = {
            "n_processes": int(topology.get("n_processes", 1)),
            "process_index": me,
        }
    all_procs = (
        list(range(int(topology["n_processes"]))) if topology else [0]
    )
    members = []

    def add_array(arr: np.ndarray, encoding=None) -> str:
        name = f"a{len(members)}"
        if encoding is not None:
            manifest["encodings"][name] = encoding
        members.append((name + ".npy", *_member_bytes(arr)))
        return name

    for comps, leaf in flatten_with_path(snapshot):
        entry: Dict[str, Any] = {"path": comps}
        pkey = ckpt_manifest.path_key(comps)
        if isinstance(leaf, torch.Tensor):
            shape = list(leaf.shape)
            name = dtype_name(leaf.dtype)
            idx_doc = [[0, int(n)] for n in shape]
            owner = ckpt_manifest.elect_owner(
                ckpt_manifest.shard_key(pkey, idx_doc), [me]
            )
            encoding = (
                {"dtype": name, "shape": shape} if name in _RAW else None
            )
            entry.update({
                "kind": "shards", "shape": shape, "dtype": name,
                "domains": [
                    {"idx": idx_doc, "replicas": [me], "owner": owner}
                ],
                "shards": [{
                    "idx": idx_doc, "replicas": [me], "owner": owner,
                    "a": add_array(host_bytes(leaf), encoding),
                }],
            })
        elif isinstance(leaf, (np.ndarray, np.generic)):
            entry["kind"] = "array"
            entry["replicas"] = all_procs
            entry["owner"] = ckpt_manifest.elect_owner(
                ckpt_manifest.shard_key(pkey, "full"), all_procs
            )
            entry["a"] = add_array(np.asarray(leaf))
        elif leaf is None or isinstance(leaf, (bool, int, float, str)):
            entry["kind"] = "py"
            entry["v"] = leaf
        else:
            raise ArchiveError(
                f"unserializable checkpoint leaf of type "
                f"{type(leaf).__name__} at {_path_json(comps)}"
            )
        manifest["leaves"].append(entry)

    with zipfile.ZipFile(
        fileobj, "w", zipfile.ZIP_STORED, allowZip64=True
    ) as zf:
        manifest["digests"] = _write_members(zf, fileobj, members)
        zf.writestr(
            _MANIFEST, json.dumps(manifest, separators=(",", ":"))
        )
    try:
        return fileobj.tell()
    except (OSError, AttributeError):
        return -1


def _read_exact(fileobj, fd, view: memoryview, pos: int) -> None:
    while view.nbytes:
        if fd is not None:
            n = os.preadv(fd, [view], pos)
        else:
            fileobj.seek(pos)
            n = fileobj.readinto(view)
        if not n:
            raise ArchiveError("archive truncated")
        pos += n
        view = view[n:]


class _Source:
    """Positioned reads of an archive: ``preadv`` on a real file (no
    shared position, so threads read side by side), else seek and read
    under a lock."""

    def __init__(self, fileobj):
        self.fileobj = fileobj
        try:
            self.fd = fileobj.fileno()
        except (AttributeError, OSError, io.UnsupportedOperation):
            self.fd = None
        self.lock = (contextlib.nullcontext() if self.fd is not None
                     else threading.Lock())

    def read_into(self, view: memoryview, pos: int) -> None:
        with self.lock:
            _read_exact(self.fileobj, self.fd, view, pos)

    def read(self, pos: int, n: int) -> bytes:
        buf = bytearray(n)
        self.read_into(memoryview(buf), pos)
        return bytes(buf)


def _member_layout(src: _Source, zinfo: zipfile.ZipInfo):
    """(npy header, offset of the data, shape, dtype) of a stored .npy
    member, its size checked against the zip entry's."""
    if zinfo.compress_type != zipfile.ZIP_STORED:
        raise ArchiveError(f"member {zinfo.filename} is compressed")
    name_len, extra_len = struct.unpack(
        "<HH", src.read(zinfo.header_offset + 26, 4))
    pos = zinfo.header_offset + 30 + name_len + extra_len
    head = src.read(pos, min(zinfo.file_size, 12))
    if head[:6] != _NPY_MAGIC or len(head) < 12:
        raise ArchiveError(f"member {zinfo.filename} is not an .npy array")
    hlen = (10 + struct.unpack("<H", head[8:10])[0] if head[6] == 1
            else 12 + struct.unpack("<I", head[8:12])[0])
    header = src.read(pos, hlen)
    try:
        hf = io.BytesIO(header)
        version = np.lib.format.read_magic(hf)
        reader = {(1, 0): np.lib.format.read_array_header_1_0,
                  (2, 0): np.lib.format.read_array_header_2_0}[version]
        shape, fortran, dtype = reader(hf)
    except (KeyError, ValueError) as e:
        raise ArchiveError(f"member {zinfo.filename}: bad .npy header {e}")
    if fortran or dtype.hasobject:
        raise ArchiveError(f"member {zinfo.filename}: unsupported layout")
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if hlen + nbytes != zinfo.file_size:
        raise ArchiveError(
            f"member {zinfo.filename}: {zinfo.file_size} bytes for an "
            f"array of {nbytes}")
    return header, pos + hlen, shape, dtype


def _check_digest(zinfo, want: Optional[str], digest) -> None:
    if digest.hexdigest() != want:
        raise DigestMismatchError(
            f"archive member {zinfo.filename!r} sha256 mismatch "
            f"(stored {want[:12]}..., computed "
            f"{digest.hexdigest()[:12]}...): checkpoint corrupt"
        )


def _read_member(src: _Source, zinfo: zipfile.ZipInfo,
                 want: Optional[str]) -> np.ndarray:
    """One stored member read straight into its array, held to its
    recorded sha256 (``want``; None skips the check)."""
    header, pos, shape, dtype = _member_layout(src, zinfo)
    arr = np.empty(shape, dtype=dtype)
    data = memoryview(arr.reshape(-1)).cast("B")
    src.read_into(data, pos)
    if want is not None:
        digest = hashlib.sha256(header)
        digest.update(data)
        _check_digest(zinfo, want, digest)
    return arr


#: bytes of each pinned slot a restore streams members to the card
#: through (one slot per reader thread)
_RING_SLOT = 64 << 20


class _Ring:
    """Pinned host slots, each with its own stream, that members pass
    through on their way to the card: a slot's next read waits for its
    previous copy. Fresh host memory costs more than the reads, so a
    restore never holds more than the slots on the host."""

    def __init__(self, device: torch.device, slots: int):
        self._free = queue.SimpleQueue()
        self._streams = [torch.cuda.Stream(device) for _ in range(slots)]
        host = torch.empty(slots * _RING_SLOT, dtype=torch.uint8,
                           pin_memory=True)
        for k, stream in enumerate(self._streams):
            part = host[k * _RING_SLOT:(k + 1) * _RING_SLOT]
            self._free.put((part, stream, None))

    def stream_member(self, src: _Source, zinfo: zipfile.ZipInfo,
                      want: Optional[str], dst: torch.Tensor) -> None:
        """Copy one member into ``dst`` (a contiguous tensor of the same
        bytes on the card) slot-sized part by part, hashing each part on
        the host; raise on a digest mismatch once every part is in."""
        header, pos, _, _ = _member_layout(src, zinfo)
        out = dst.view(-1).view(torch.uint8)
        if zinfo.file_size - len(header) != out.numel():
            raise ArchiveError(
                f"member {zinfo.filename}: {zinfo.file_size - len(header)} "
                f"bytes for a target of {out.numel()}")
        digest = hashlib.sha256(header)
        host, stream, copied = self._free.get()
        try:
            view = memoryview(host.numpy())
            for done in range(0, out.numel(), _RING_SLOT):
                n = min(_RING_SLOT, out.numel() - done)
                if copied is not None:
                    copied.synchronize()
                src.read_into(view[:n], pos + done)
                if want is not None:
                    digest.update(view[:n])
                with torch.cuda.stream(stream):
                    out[done:done + n].copy_(host[:n], non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(stream)
        finally:
            self._free.put((host, stream, copied))
        if want is not None:
            _check_digest(zinfo, want, digest)

    def wait(self) -> None:
        """Until every copy has landed on the card."""
        for stream in self._streams:
            stream.synchronize()


def _open_archive(fileobj: BinaryIO):
    """``(manifest, {member name: zip entry})`` of an archive in a
    SEEKABLE binary file, the manifest and its digests validated."""
    try:
        with zipfile.ZipFile(fileobj) as zf:
            manifest = json.loads(zf.read(_MANIFEST).decode("utf-8"))
            infos = [z for z in zf.infolist() if z.filename != _MANIFEST]
    except Exception as e:
        raise ArchiveError(f"corrupt checkpoint archive: {e}")
    if not isinstance(manifest, dict):
        raise ArchiveError("archive manifest malformed")
    if manifest.get("version") not in _SUPPORTED_VERSIONS:
        raise ArchiveError(
            f"unsupported archive version {manifest.get('version')!r}"
        )
    digests = manifest.get("digests") or {}
    if not isinstance(digests, dict):
        raise ArchiveError("archive digests field malformed")
    names = {z.filename for z in infos}
    missing = sorted(set(digests) - names)
    if missing:
        raise ArchiveError(f"archive missing member {missing[0]!r}")
    return manifest, {z.filename[:-4]: z for z in infos
                      if z.filename.endswith(".npy")}


def _load_members(fileobj: BinaryIO, manifest, infos, verify: bool = True,
                  dests: Optional[Dict[str, torch.Tensor]] = None):
    """Read and verify the members: ``{member: CPU tensor}`` for those
    without a destination; a member of ``dests`` goes straight into its
    tensor on the card, through a pinned ring. Every member that the
    manifest carries a sha256 for is held to it before this returns
    (members of pre-digest archives are accepted as they are), by
    several threads. ``verify=False`` skips the hashes (for measuring
    what they cost)."""
    dests = dests or {}
    missing = sorted(set(dests) - set(infos))
    if missing:
        raise ArchiveError(f"archive missing member {missing[0]!r}")
    digests = manifest.get("digests") or {}
    src = _Source(fileobj)
    devices = {t.device for t in dests.values()}
    rings = {d: _Ring(d, _WORKERS) for d in devices}

    def one(name):
        zinfo = infos[name]
        want = digests.get(zinfo.filename) if verify else None
        if name in dests:
            rings[dests[name].device].stream_member(
                src, zinfo, want, dests[name])
            return None
        return _read_member(src, zinfo, want)

    try:
        with ThreadPoolExecutor(_WORKERS) as pool:
            arrays = dict(zip(infos, pool.map(one, infos)))
    except ArchiveError:
        raise
    except Exception as e:
        raise ArchiveError(f"corrupt checkpoint archive: {e}")
    finally:
        # no copy may still be writing once the destinations can be freed
        for ring in rings.values():
            ring.wait()
    tensors = {}
    encodings = manifest.get("encodings", {})
    for name, arr in arrays.items():
        if arr is None:
            continue
        enc = encodings.get(name)
        if enc is None:
            tensors[name] = torch.from_numpy(arr)
            continue
        dtype = torch_dtype(enc.get("dtype"))
        try:
            raw = torch.from_numpy(arr.reshape(-1))
            tensors[name] = raw.view(torch.uint8).view(dtype).reshape(
                enc["shape"])
        except (RuntimeError, TypeError, ValueError) as e:
            raise ArchiveError(
                f"archive member {name} inconsistent with its recorded "
                f"encoding: {e}"
            )
    return tensors


def _assemble(entry, arrays) -> torch.Tensor:
    shape = tuple(entry["shape"])
    shards = entry["shards"]
    if len(shards) == 1 and ckpt_manifest.normalize_index(
            shards[0]["idx"], shape) == [[0, n] for n in shape]:
        return arrays[shards[0]["a"]].reshape(shape)
    full = torch.zeros(shape, dtype=torch_dtype(entry["dtype"]))
    for s in shards:
        idx = tuple(slice(a, b) for a, b in s["idx"])
        full[idx] = arrays[s["a"]]
    return full


def _leaf_from_entry(entry, arrays):
    kind = entry.get("kind")
    try:
        if kind == "shards":
            return _assemble(entry, arrays)
        if kind == "array":
            return arrays[entry["a"]]
    except KeyError as e:
        raise ArchiveError(f"archive missing member {e}")
    if kind == "py":
        v = entry.get("v")
        if v is not None and not isinstance(v, (bool, int, float, str)):
            raise ArchiveError(f"non-primitive py leaf {type(v).__name__}")
        return v
    raise ArchiveError(f"unknown leaf kind {kind!r}")


def _onto(leaf, tgt, path):
    """An archived leaf as the target leaf asks: a tensor of the same
    shape and dtype on the target's device."""
    if not isinstance(tgt, torch.Tensor):
        return leaf
    if not isinstance(leaf, torch.Tensor):
        raise ArchiveError(f"{path}: archive holds {leaf!r}, not a tensor")
    if tuple(leaf.shape) != tuple(tgt.shape) or leaf.dtype != tgt.dtype:
        raise ArchiveError(
            f"{path}: archive holds {leaf.dtype}{list(leaf.shape)}, the "
            f"target {tgt.dtype}{list(tgt.shape)}"
        )
    return leaf.to(tgt.device)


def _device_dest(entry, tgt, path) -> Optional[torch.Tensor]:
    """An empty tensor on the card for a target tensor there whose entry
    is one shard covering the whole array (what one process writes), so
    its member can be streamed into it; None for any other leaf."""
    if not (isinstance(tgt, torch.Tensor) and tgt.is_cuda
            and entry.get("kind") == "shards"):
        return None
    shape = tuple(entry.get("shape", ()))
    shards = entry.get("shards") or []
    if len(shards) != 1 or ckpt_manifest.normalize_index(
            shards[0]["idx"], shape) != [[0, n] for n in shape]:
        return None
    if shape != tuple(tgt.shape) or entry.get("dtype") != dtype_name(
            tgt.dtype):
        raise ArchiveError(
            f"{path}: archive holds {entry.get('dtype')}{list(shape)}, "
            f"the target {tgt.dtype}{list(tgt.shape)}"
        )
    return torch.empty(shape, dtype=tgt.dtype, device=tgt.device)


def snapshot_from_file(fileobj: BinaryIO, target: Any = None,
                       verify: bool = True):
    """Read an archive back as ``(tree, step)``, every member held to its
    digest before anything is returned.

    With ``target`` (a tree of the desired structure), the leaves are put
    into the target's structure, each tensor on the target tensor's
    device after its shape and dtype were checked; the paths must match
    exactly. A tensor bound for the card streams there through a small
    pinned ring, without a host copy of the whole state. Without a
    target the tree is rebuilt as nested dicts from the recorded key
    paths (a list index becomes an int key), as the JAX reader rebuilds
    it; tensors stay on the CPU. ``verify=False`` skips the digests:
    only for measuring what they cost.
    """
    manifest, infos = _open_archive(fileobj)
    entries = manifest["leaves"]
    step = int(manifest["step"])

    if target is not None:
        flat = flatten_with_path(target)
        tpaths = [_path_json(p) for p, _ in flat]
        by_path = {_path_json(e["path"]): e for e in entries}
        if set(tpaths) != set(by_path):
            missing = sorted(set(tpaths) - set(by_path))[:3]
            extra = sorted(set(by_path) - set(tpaths))[:3]
            raise ArchiveError(
                f"checkpoint/target structure mismatch "
                f"(missing={missing}, extra={extra})"
            )
        dests = {}
        for p, (_, t) in zip(tpaths, flat):
            dst = _device_dest(by_path[p], t, p)
            if dst is not None:
                dests[by_path[p]["shards"][0]["a"]] = dst
        arrays = _load_members(fileobj, manifest, infos, verify, dests)
        arrays.update(dests)
        leaves = [
            _onto(_leaf_from_entry(by_path[p], arrays), t, p)
            for p, (_, t) in zip(tpaths, flat)
        ]
        return unflatten_like(target, leaves), step

    arrays = _load_members(fileobj, manifest, infos, verify)
    if not entries:
        return None, step
    root: Dict[Any, Any] = {}
    for e in entries:
        node = root
        comps = e["path"]
        for i, c in enumerate(comps):
            key = c.get("k", c.get("i"))
            if i == len(comps) - 1:
                node[key] = _leaf_from_entry(e, arrays)
            else:
                node = node.setdefault(key, {})
    return root, step


def read_manifest(fileobj: BinaryIO) -> Dict[str, Any]:
    """The archive's JSON manifest alone -- no member loads, no digest
    pass; the position of ``fileobj`` is restored. Raises
    :class:`ArchiveError` on anything unreadable."""
    try:
        pos = fileobj.tell()
        with zipfile.ZipFile(fileobj) as zf:
            manifest = json.loads(zf.read(_MANIFEST).decode("utf-8"))
        fileobj.seek(pos)
    except ArchiveError:
        raise
    except Exception as e:
        raise ArchiveError(f"unreadable archive manifest: {e}")
    if not isinstance(manifest, dict):
        raise ArchiveError("archive manifest malformed")
    if manifest.get("version") not in _SUPPORTED_VERSIONS:
        raise ArchiveError(
            f"unsupported archive version {manifest.get('version')!r}"
        )
    return manifest


def archive_last_good(fileobj: BinaryIO) -> Optional[bool]:
    """Peek the sentinel verdict out of an archive's manifest WITHOUT
    loading (or digest-verifying) the arrays — the RAM-tier restore
    path must be able to reject a tainted archive for pennies. Returns
    None for untagged (pre-sentinel) or unreadable archives: both are
    treated as clean, matching :func:`step_last_good`."""
    try:
        v = read_manifest(fileobj).get("last_good")
    except ArchiveError:
        return None
    return None if v is None else bool(v)


# --------------------------------------------------------------------------
# object stores
# --------------------------------------------------------------------------


class ObjectStore(ABC):
    """Flat-key blob store: the semantics a bucket provides.

    No rename, no partial writes visible (each ``put`` is atomic per
    object), listing by prefix. Atomic multi-object commits are built
    ON TOP via commit markers (see module docstring layout)."""

    @abstractmethod
    def put(self, key: str, data: bytes) -> None: ...

    @abstractmethod
    def get(self, key: str) -> bytes: ...

    @abstractmethod
    def list(self, prefix: str = "") -> List[str]: ...

    @abstractmethod
    def delete(self, key: str) -> None: ...

    def exists(self, key: str) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    def put_stream(self, key: str, fileobj: BinaryIO,
                   size: Optional[int] = None) -> None:
        """Upload from a file object. The base default buffers (small
        stores/tests); LocalFsStore streams in chunks so a
        multi-GB archive never needs a contiguous bytes value."""
        self.put(key, fileobj.read())

    def open_read(self, key: str) -> BinaryIO:
        """A seekable binary reader for ``key`` (KeyError if absent).
        The base default wraps ``get``; LocalFsStore opens the backing
        file directly (no whole-object copy)."""
        return io.BytesIO(self.get(key))


class LocalFsStore(ObjectStore):
    """Directory-backed shim with object-store semantics (the test
    stand-in for a bucket; also the right thing on a shared NFS/Filestore
    mount). ``put`` stays atomic via tmp+rename INTERNALLY, but callers
    only see put/get/list — code written against this runs unchanged
    against a bucket store."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _fs_path(self, key: str) -> str:
        safe = os.path.normpath(key)
        if safe.startswith("..") or os.path.isabs(safe):
            raise KeyError(f"invalid object key {key!r}")
        return os.path.join(self.root, safe)

    def put(self, key: str, data: bytes) -> None:
        path = self._fs_path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def get(self, key: str) -> bytes:
        try:
            with open(self._fs_path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key)

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                rel = os.path.relpath(
                    os.path.join(dirpath, name), self.root
                )
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._fs_path(key))
        except FileNotFoundError:
            pass

    def exists(self, key: str) -> bool:
        # metadata-only: the base-class default get()s the whole blob
        return os.path.isfile(self._fs_path(key))

    def put_stream(self, key: str, fileobj: BinaryIO,
                   size: Optional[int] = None) -> None:
        path = self._fs_path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            shutil.copyfileobj(fileobj, f, _STREAM_CHUNK)
        os.replace(tmp, path)

    def open_read(self, key: str) -> BinaryIO:
        try:
            return open(self._fs_path(key), "rb")
        except FileNotFoundError:
            raise KeyError(key)


def get_store(url: str) -> ObjectStore:
    """``file:///p`` or a plain path -> LocalFsStore. A ``gs://`` URL
    raises: the bucket store needs ``google-cloud-storage`` and is not
    ported (ROADMAP.md, queue A); a bucket mounted with gcsfuse is a
    plain path."""
    if url.startswith("gs://"):
        raise NotImplementedError(
            f"{url}: GcsStore is not ported yet (ROADMAP.md, queue A); "
            "mount the bucket and pass its path"
        )
    if url.startswith("file://"):
        return LocalFsStore(url[len("file://"):])
    return LocalFsStore(url)


def is_url(path: str) -> bool:
    return "://" in path


# --------------------------------------------------------------------------
# step layout over a store
# --------------------------------------------------------------------------


def step_key(step: int, process_index: int, attempt: str = "0") -> str:
    return f"step-{step}/proc-{process_index}.a{attempt}.ckpt"


def commit_key(step: int) -> str:
    return f"step-{step}/COMMIT"


def put_shard_stream(store: ObjectStore, step: int, process_index: int,
                     fileobj: BinaryIO, attempt: str = "0",
                     size: Optional[int] = None) -> None:
    """Upload this process's archive from a file object (the RAM-tier
    tmpfs archive) -- chunked, never a full in-memory copy."""
    store.put_stream(
        step_key(step, process_index, attempt), fileobj, size=size
    )


def open_step(store: ObjectStore, step: int,
              process_index: int) -> BinaryIO:
    """Streaming read of this process's shard for a COMMITTED step
    (KeyError if uncommitted or missing)."""
    manifest = _commit_manifest(store, step)
    return store.open_read(
        step_key(step, process_index, str(manifest.get("attempt", "0")))
    )


def commit_step(store: ObjectStore, step: int, attempt: str = "0",
                last_good: Optional[bool] = None) -> None:
    """Publish the COMMIT marker of a one-process save, after its data
    object: a step without it is invisible to readers. ``last_good``
    (tri-state) carries the saver's sentinel verdict into the COMMIT doc
    so :func:`step_last_good` can read it without opening an archive.
    The barrier that waits for every process's shard first comes with
    the multi-process slice (ROADMAP.md, queue A)."""
    doc = {"step": step, "n_processes": 1, "attempt": attempt}
    if last_good is not None:
        doc["last_good"] = bool(last_good)
    store.put(commit_key(step), json.dumps(doc).encode("utf-8"))


def committed_steps(store: ObjectStore) -> List[int]:
    steps = []
    for key in store.list():
        parts = key.split("/")
        if len(parts) == 2 and parts[1] == "COMMIT":
            try:
                steps.append(int(parts[0].split("-", 1)[1]))
            except (IndexError, ValueError):
                continue
    return sorted(steps)


def _commit_manifest(store: ObjectStore, step: int) -> Dict[str, Any]:
    try:
        doc = json.loads(store.get(commit_key(step)).decode("utf-8"))
    except KeyError:
        raise
    except Exception as e:
        raise KeyError(f"step {step} COMMIT unreadable: {e}")
    if not isinstance(doc, dict):
        raise KeyError(f"step {step} COMMIT malformed")
    return doc


def step_last_good(store: ObjectStore, step: int) -> Optional[bool]:
    """The sentinel verdict recorded at commit time: False = saved
    inside an anomaly window, True = sentinel-clean, None = no verdict
    (pre-sentinel archive, or unreadable COMMIT — treated as clean by
    callers, matching pre-tag behavior)."""
    try:
        v = _commit_manifest(store, step).get("last_good")
    except KeyError:
        return None
    return None if v is None else bool(v)


def available_steps(store: ObjectStore, process_index: int) -> List[int]:
    """Committed steps this process can actually restore (a committed
    step can still lose an object; readers must not select it)."""
    out = []
    for s in committed_steps(store):
        try:
            manifest = _commit_manifest(store, s)
        except KeyError:
            continue
        attempt = str(manifest.get("attempt", "0"))
        if store.exists(step_key(s, process_index, attempt)):
            out.append(s)
    return out


def gc_steps(store: ObjectStore, keep: int) -> None:
    """Prune old committed steps AND orphaned uncommitted ones.

    Orphans (shards whose save never committed — a peer died mid-save)
    are deleted only when strictly OLDER than the newest committed
    step: an in-flight save always targets a step beyond it, so this
    never races a write in progress."""
    steps = committed_steps(store)
    for step in steps[:-keep] if keep > 0 else []:
        # delete COMMIT first so a concurrent reader can't pick a step
        # whose data objects are being removed
        store.delete(commit_key(step))
        for key in store.list(f"step-{step}/"):
            store.delete(key)
    if not steps:
        return
    newest, kept = steps[-1], set(steps[-keep:] if keep > 0 else steps)
    seen_dirs = set()
    for key in store.list():
        top = key.split("/", 1)[0]
        if not top.startswith("step-") or top in seen_dirs:
            continue
        seen_dirs.add(top)
        try:
            s = int(top.split("-", 1)[1])
        except ValueError:
            continue
        if s < newest and s not in kept:
            for k in store.list(f"{top}/"):
                store.delete(k)
