"""Build the port's CUDA kernels at first use and load them with ctypes.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``
(Hopper), one process per source, all started together, and linked into
one shared library with a plain C interface. The library lands in
``build/kernels/<hash>/`` at the root of the checkout; the hash covers
the sources and the flags, so an edit rebuilds and an unchanged tree
loads the library it built before. Nothing is built when this module is
imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_fwd.cu", "flash_dq.cu", "flash_dkv.cu")
HEADERS = ("flash_common.cuh", "flash_sm90.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libdlrover_flash.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: kernels whose warpgroups trade registers with setmaxnreg
#: (csrc/flash_sm90.cuh), and the registers a thread their launch must
#: reserve: 65,536 / 384 threads, in ptxas's steps of 8. With fewer,
#: setmaxnreg.inc waits for registers that never come and the launch hangs.
WARP_SPECIALIZED = ("fwd_kernel", "dq_kernel", "dkv_kernel")
WARP_SPECIALIZED_REGS = 168

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures of the library's entry points; every pointer and the
#: stream are c_void_p so that ctypes passes all 64 bits
SIGNATURES = {
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _P, _I, _P],
    "flash_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _P, _I, _P],
    "flash_dkv": [_P] * 8 + [_I] * 5 + [_F, _I, _P, _I, _I, _P, _P],
    "flash_fwd_smem": [_I],
    "flash_dq_smem": [_I],
    "flash_dkv_smem": [_I],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build in this process took (0.0 when it was cached)
last_build_seconds = 0.0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this machine"
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> Path:
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs: List[str] = []
    failed = []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name} ==\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    (out_dir / "nvcc.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}:\n" + "\n".join(logs)
        )
    check_registers("\n".join(logs))
    lib = out_dir / LIB_NAME
    link = subprocess.run(
        [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    return lib


def check_registers(log: str) -> None:
    """Raise unless ptxas (``-Xptxas -v`` output ``log``) gave every
    instance of the warp-specialized kernels WARP_SPECIALIZED_REGS
    registers, so that a build that would hang the card is never
    loaded."""
    entry, found, wrong = None, set(), []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in WARP_SPECIALIZED if k in line), None)
        elif entry and "registers" in line:
            found.add(entry)
            if f"Used {WARP_SPECIALIZED_REGS} registers" not in line:
                wrong.append(f"{entry}: {line.strip()}")
            entry = None
    missing = set(WARP_SPECIALIZED) - found
    if wrong or missing:
        raise RuntimeError(
            f"ptxas must give the warp-specialized kernels "
            f"{WARP_SPECIALIZED_REGS} registers a thread; got {wrong}, no "
            f"register count for {sorted(missing)}")


def build() -> Path:
    """Compile the kernels unless this tree's build exists; the path of
    the shared library."""
    global last_build_seconds
    final = BUILD_ROOT / source_hash()
    lib = final / LIB_NAME
    if lib.exists():
        last_build_seconds = 0.0
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_ROOT / f"{final.name}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    t0 = time.perf_counter()
    _compile(nvcc_path(), tmp)
    last_build_seconds = time.perf_counter() - t0
    try:
        os.replace(tmp, final)
    except OSError:
        # another process finished the same build first: use its copy
        shutil.rmtree(tmp, ignore_errors=True)
    logger.info("built %s in %.1f s", final / LIB_NAME, last_build_seconds)
    return lib


def build_log() -> str:
    """nvcc's output (ptxas registers, shared memory, spills) for the
    current sources, or '' before they were built."""
    path = BUILD_ROOT / source_hash() / "nvcc.log"
    return path.read_text() if path.exists() else ""


def load_library() -> ctypes.CDLL:
    """The kernels' library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
