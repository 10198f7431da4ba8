"""Python bindings for the native shared-memory batch ring.

Counterpart of ``dlrover_tpu/data/shm_ring.py``. The ring is host C++
(``csrc/shm_ring.cpp``, the JAX package's source copied: one shm
segment holding a process-shared robust mutex, two condvars and the
slots), loaded with ctypes. The batch framing is the JAX package's byte
for byte: numpy arrays go with a small header and no pickle, any other
tree is pickled. So a producer of either package can feed a ring the
other created.

The library is built with ``g++`` at first use into
``build/native/<hash>/libshm_ring.so`` at the root of the checkout; the
hash covers the source and the flags, so an edit rebuilds and the JAX
package's build (in its own cache directory) is never this one's.
Nothing is built when this module is imported. numpy only: the
coworker processes load this module, and no torch.
"""

import ctypes
import hashlib
import io
import os
import pickle
import struct
import subprocess
import threading
from pathlib import Path
from typing import Any, List

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger

SRC = Path(__file__).resolve().parent / "csrc" / "shm_ring.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libshm_ring.so"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
#: the name of every segment this package's loaders create starts with
#: this, then the creating process's pid in hex: what is left of a dead
#: worker's rings can be found and unlinked (``unlink_segments_of``)
SEGMENT_PREFIX = "dlrover_torch_shm_"

_LIB_LOCK = threading.Lock()
_LIB = None

_NUMPY_MAGIC = b"DLRN"
_PICKLE_MAGIC = b"DLRP"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the ring unless this source's build exists; the path of
    the shared library."""
    lib = BUILD_ROOT / source_hash() / LIB_NAME
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.tmp.{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread", "-lrt"]
    logger.info("Building the shm ring: %s", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib


def _load_library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.shm_ring_create.restype = ctypes.c_void_p
            lib.shm_ring_create.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ]
            lib.shm_ring_attach.restype = ctypes.c_void_p
            lib.shm_ring_attach.argtypes = [ctypes.c_char_p]
            lib.shm_ring_push.restype = ctypes.c_int
            lib.shm_ring_push.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_long,
            ]
            lib.shm_ring_pop.restype = ctypes.c_int64
            lib.shm_ring_pop.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_long,
            ]
            lib.shm_ring_size.restype = ctypes.c_int
            lib.shm_ring_size.argtypes = [ctypes.c_void_p]
            lib.shm_ring_slot_size.restype = ctypes.c_uint64
            lib.shm_ring_slot_size.argtypes = [ctypes.c_void_p]
            lib.shm_ring_close.argtypes = [ctypes.c_void_p]
            lib.shm_ring_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def segments_of(pid: int) -> List[str]:
    """The shm segments (``/dev/shm`` names) of this package's loaders
    that process ``pid`` created and has not destroyed."""
    head = f"{SEGMENT_PREFIX}{pid:x}_"
    try:
        return sorted(n for n in os.listdir("/dev/shm") if n.startswith(head))
    except OSError:
        return []


def unlink_segments_of(pid: int) -> List[str]:
    """Unlink what is left of the rings of a process that died without
    destroying them (a crash, a drain's ``os._exit``); the names."""
    gone = []
    for name in segments_of(pid):
        try:
            os.unlink(os.path.join("/dev/shm", name))
            gone.append(name)
        except OSError:
            pass
    return gone


class RingClosed(Exception):
    """Producer closed the ring and all slots are drained."""


class ShmRing:
    """One shared-memory ring. Create in the owning process, attach from
    coworker processes by name."""

    def __init__(self, name: str, slot_bytes: int = 64 << 20,
                 num_slots: int = 8, create: bool = True):
        self._lib = _load_library()
        self.name = name
        self.slot_bytes = slot_bytes
        if create:
            self._handle = self._lib.shm_ring_create(
                name.encode(), slot_bytes, num_slots
            )
        else:
            self._handle = self._lib.shm_ring_attach(name.encode())
            if self._handle:
                # slot size is whatever the creator laid out -- read it
                # from the control block so pop buffers always fit
                self.slot_bytes = int(
                    self._lib.shm_ring_slot_size(self._handle)
                )
        if not self._handle:
            raise OSError(f"shm ring {'create' if create else 'attach'} "
                          f"failed for {name!r}")
        self._buf = ctypes.create_string_buffer(self.slot_bytes)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        """Attach to an existing ring; slot size comes from its control
        block, so there is no layout knob on this side."""
        return cls(name, create=False)

    def push_bytes(self, data: bytes, timeout_ms: int = 60_000):
        rc = self._lib.shm_ring_push(
            self._handle, data, len(data), timeout_ms
        )
        if rc == -1:
            raise TimeoutError("shm ring push timed out")
        if rc == -2:
            raise ValueError(
                f"payload {len(data)}B exceeds slot {self.slot_bytes}B"
            )
        if rc == -3:
            raise RingClosed()
        if rc != 0:
            raise OSError(f"shm ring push failed rc={rc}")

    def pop_bytes(self, timeout_ms: int = 60_000) -> bytes:
        rc = self._lib.shm_ring_pop(
            self._handle, self._buf, self.slot_bytes, timeout_ms
        )
        if rc == -1:
            raise TimeoutError("shm ring pop timed out")
        if rc == -3:
            raise RingClosed()
        if rc < 0:
            raise OSError(f"shm ring pop failed rc={rc}")
        # the payload only: ``.raw`` would copy the whole slot first
        return ctypes.string_at(self._buf, rc)

    # -- batch framing ----------------------------------------------------

    def push(self, batch: Any, timeout_ms: int = 60_000):
        """Push a numpy array / tuple of arrays / arbitrary pytree."""
        self.push_bytes(_encode(batch), timeout_ms)

    def pop(self, timeout_ms: int = 60_000) -> Any:
        return _decode(self.pop_bytes(timeout_ms))

    def __len__(self) -> int:
        return max(0, self._lib.shm_ring_size(self._handle))

    def close(self):
        """Signal EOF to consumers (drain then RingClosed). No-op after
        destroy: shm_ring_close(NULL) would be a native NULL deref."""
        if self._handle:
            self._lib.shm_ring_close(self._handle)

    def destroy(self):
        if self._handle:
            self._lib.shm_ring_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass


def _encode(batch: Any) -> bytes:
    arrays = None
    if isinstance(batch, np.ndarray):
        arrays = [batch]
    elif isinstance(batch, (tuple, list)) and all(
        isinstance(a, np.ndarray) for a in batch
    ):
        arrays = list(batch)
    if arrays is not None:
        out = io.BytesIO()
        out.write(_NUMPY_MAGIC)
        out.write(struct.pack("<I", len(arrays)))
        for a in arrays:
            hdr = pickle.dumps((a.dtype.str, a.shape), protocol=4)
            out.write(struct.pack("<I", len(hdr)))
            out.write(hdr)
            out.write(np.ascontiguousarray(a).tobytes())
        return out.getvalue()
    return _PICKLE_MAGIC + pickle.dumps(batch, protocol=4)


def _decode(data: bytes) -> Any:
    magic, body = data[:4], memoryview(data)[4:]
    if magic == _PICKLE_MAGIC:
        return pickle.loads(body)
    if magic != _NUMPY_MAGIC:
        raise ValueError("unrecognized shm batch framing")
    (n,) = struct.unpack_from("<I", body, 0)
    off = 4
    arrays = []
    for _ in range(n):
        (hlen,) = struct.unpack_from("<I", body, off)
        off += 4
        dtype_str, shape = pickle.loads(body[off:off + hlen])
        off += hlen
        count = int(np.prod(shape)) if shape else 1
        a = np.frombuffer(
            body, dtype=np.dtype(dtype_str), count=count, offset=off,
        ).reshape(shape)
        off += a.nbytes
        arrays.append(a.copy())  # own the memory past the ring slot
    return arrays[0] if n == 1 else tuple(arrays)
