"""Build the CUDA sources under ``csrc/`` with nvcc and launch them via ctypes.

Each ``.cu`` file compiles into its own shared library with a plain C
interface: no PyTorch headers, so a build takes seconds. Builds run on
first use (never at import), one nvcc process per source, all started
together, into ``BUILD_DIR`` (ignored by git), under a name that hashes
the sources and the flags, so an edited source is rebuilt.

Flags: ``sm_90a`` (Hopper), and ``-fmad=false`` so no multiply-add is
contracted into an FMA: the kernels then give the same float32 bits as
their plain PyTorch versions and as the JAX reference.

``launches`` counts kernel launches by name. ``launch`` adds to it, right
after a launch that the runtime accepted. ``charge`` reports a kernel's
traffic to the dry run's byte counters (``launch/hlo_analysis.py``): a
ctypes launch is no aten op, so no dispatch mode sees it. Each
dispatcher charges its entry after a launch on the card and in its meta
branch alike (a tensor on PyTorch's meta device: an empty output of the
kernel's dtype and shape, nothing launched, nothing counted in
``launches``). A launch made while a CUDA graph
is captured (or in the warm-up before) runs nothing yet: ``moved_to``
takes such launches out of ``launches`` into the graph holder's record,
and ``replayed`` adds that record back at each replay of the graph.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
SOURCES = {"round_sum": "round_sum.cu", "decode_apply": "decode_apply.cu",
           "quantize": "quantize.cu", "pack": "pack.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: collections.Counter = collections.Counter()
# launches may come from several threads (the aggregator's service thread
# and its producers): each count's read-modify-write holds this lock
_counting = threading.Lock()

_libs: dict = {}
_funcs: dict = {}


# the byte counters listening to ``charge`` (launch/hlo_analysis.py)
traffic_listeners: list = []


def reset_launches() -> None:
    launches.clear()


def charge(fn: str, *tensors) -> None:
    """Report one call of entry ``fn`` with its traffic, the bytes of
    ``tensors``: each input it reads and each output it writes, once
    (``chip_smoke.py:bound``'s rule), to the listening byte counters."""
    if traffic_listeners:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        for listener in traffic_listeners:
            listener(fn, nbytes)


def is_meta(t) -> bool:
    """Whether ``t`` lies on PyTorch's meta device (a dry run's tensor)."""
    return t.device.type == "meta"


def check_meta(name: str, t, dtype) -> None:
    """Validate a meta-branch operand as ``check_cuda`` would on the card."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@contextlib.contextmanager
def moved_to(record: collections.Counter):
    """Launches made inside the block are added to ``record`` instead of
    ``launches``."""
    before = launches.copy()
    try:
        yield record
    finally:
        record.update(launches - before)
        launches.clear()
        launches.update(before)


def replayed(record: collections.Counter) -> None:
    """Count one replay of a graph whose capture launched ``record``."""
    launches.update(record)


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> dict:
    """Compile every library of ``names`` that is not built yet, all in
    parallel. Returns ``{name: nvcc output}`` (ptxas register and spill
    report) for the ones it compiled; raises with nvcc's output on failure.
    A call that starts nvcc is one ``kernels.build`` span."""
    # here, not at the top: the telemetry package imports the kernels
    from repro_torch.telemetry.timing import span

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return {}
    with span("kernels.build", libs=len(todo)):
        started = {}
        for name in todo:
            path = library_path(name)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started[name] = (proc, tmp, path)
        logs, failed = {}, []
        for name, (proc, tmp, path) in started.items():
            out, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed on {SOURCES[name]}:\n{out}")
                continue
            os.replace(tmp, path)
            logs[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def _function(lib: str, fn: str, argtypes):
    key = (lib, fn)
    if key not in _funcs:
        if lib not in _libs:
            build([lib])
            _libs[lib] = ctypes.CDLL(str(library_path(lib)))
            err = getattr(_libs[lib], f"{lib}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        f = getattr(_libs[lib], fn)
        f.argtypes, f.restype = list(argtypes), ctypes.c_int
        _funcs[key] = f
    return _funcs[key]


def call(lib: str, fn: str, argtypes, *args) -> None:
    """Call C entry ``fn`` of library ``lib``, which returns a CUDA error
    code; raise if it is not 0."""
    rc = _function(lib, fn, argtypes)(*args)
    if rc:
        msg = getattr(_libs[lib], f"{lib}_error_string")(rc).decode()
        raise RuntimeError(f"C entry {fn} of {lib} failed: {msg} ({rc})")


def launch(lib: str, fn: str, argtypes, *args) -> None:
    """Launch C entry ``fn`` of library ``lib`` (it enqueues its kernel on
    the stream passed last and returns ``cudaGetLastError()``); raise if
    the launch was refused, else count it under ``fn``."""
    call(lib, fn, argtypes, *args)
    with _counting:
        launches[fn] += 1


def check_cuda(name: str, t, dtype) -> None:
    """Validate a kernel operand: a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I32 = ctypes.c_int
U32 = ctypes.c_uint32
F32 = ctypes.c_float
