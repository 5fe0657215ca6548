"""Build, load and declare the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into ``build/torch_kernels/lib<name>-<digest>.so``, a shared library with
a plain C interface that ``ctypes`` loads.  The digest covers the sources
and flags, so an edited kernel is rebuilt at its next use and a stale
library is never loaded.  Nothing is built when the module is imported.

Each kernel's public wrapper is declared once, beside its launch code,
with :func:`hand_kernel`: a :class:`HandKernel` that carries the kernel's
name, its plain PyTorch version and its launch counts, registered in
:data:`KERNELS`.  :func:`observed` hands every launch to an observer (the
soak's and the tools' check against the plain versions, the card
script's captures); :func:`launch_counts` reads the counters by name.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
#: every hand kernel by name (its ``csrc/<name>.cu`` stem), registered
#: when its module is imported (``ops/__init__.py`` imports them all)
KERNELS: Dict[str, "HandKernel"] = {}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
#: what :func:`observed` hands each launch to, in the order opened
_observers: List[Callable] = []


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(
    names: Optional[Sequence[str]] = None, ptxas_info: bool = False
) -> Dict[str, dict]:
    """Compile every named kernel (default: all of :data:`KERNELS`) that
    has no current library, one ``nvcc`` per source, all started
    together.  Returns, per kernel, the build seconds (0 when the library
    was current) and the compiler's messages (register and shared-memory
    use with ``ptxas_info``)."""
    names = list(KERNELS) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if ptxas_info else [])
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists() and not ptxas_info:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    report = {n: {"seconds": 0.0, "log": ""} for n in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def on_card(t: torch.Tensor) -> bool:
    """The one route rule of the hand kernels: a call whose tensor is on
    a CUDA device launches the kernel and never falls back; any other
    runs the plain version."""
    return t.is_cuda


class HandKernel:
    """The public wrapper of kernel ``csrc/<name>.cu``.

    A call routes on its ``on`` tensor (:func:`on_card`): off the card it
    returns ``plain(*args, **kw)``, the kernel's plain PyTorch version,
    which takes the wrapper's own arguments; on the card it runs
    ``code(self, *args, **kw)``, the kernel's own part (input checks,
    outputs, argument marshalling, :meth:`launch`), then hands the call to
    every open observer (:func:`observed`).  ``launches`` counts the
    launches, ``segmented_launches`` those of them that walked rows in
    segments (the tile scan's)."""

    def __init__(self, code: Callable, plain: Callable,
                 on: Optional[str] = None) -> None:
        functools.update_wrapper(self, code)
        sig = inspect.signature(code)
        params = list(sig.parameters.values())[1:]  # after the entry
        self.__signature__ = sig.replace(parameters=params)
        self.name, self.code, self.plain = code.__name__, code, plain
        on = on or params[0].name
        self._on = ([p.name for p in params].index(on), on)
        self.launches = 0
        self.segmented_launches = 0

    def __call__(self, *args, **kw):
        at, on = self._on
        if not on_card(args[at] if at < len(args) else kw[on]):
            return self.plain(*args, **kw)
        out = self.code(self, *args, **kw)
        for see in _observers:
            see(self, args, kw, out)
        return out

    def entry_point(self, symbol: str, argtypes: list,
                    restype=ctypes.c_int):
        """C function ``symbol`` of this kernel's library (built at first
        use), typed once."""
        fn = getattr(load_library(self.name), symbol)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = argtypes, restype
        return fn

    def launch_shape(self, symbol: str, argtypes: list, *args) -> dict:
        """Grid, block and resident blocks per SM that C function
        ``symbol`` gives for a launch on ``args`` on the current CUDA
        device (launches nothing)."""
        out = [ctypes.c_int() for _ in range(3)]
        rc = self.entry_point(symbol, argtypes)(*args, *map(ctypes.byref, out))
        if rc != 0:
            raise RuntimeError(f"{symbol}: CUDA error {rc}")
        return dict(zip(("grid", "block", "blocks_per_sm"),
                        (v.value for v in out)))

    def launch(self, fn, device: torch.device, *args,
               segmented: bool = False) -> None:
        """``fn(*args, stream)`` on ``device``'s current stream; raises on
        a nonzero return code, else counts the launch."""
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {rc}")
        self.launches += 1
        if segmented:
            self.segmented_launches += 1


def hand_kernel(plain: Callable, on: Optional[str] = None):
    """Declare the function below as the launch code of the hand kernel
    of its name, with ``plain`` its plain version; ``on`` names the
    tensor argument that routes a call (default: the first)."""

    def declare(code: Callable) -> HandKernel:
        KERNELS[code.__name__] = HandKernel(code, plain, on)
        return KERNELS[code.__name__]

    return declare


@contextlib.contextmanager
def observed(see: Callable) -> Iterator[None]:
    """While open, every call of a hand kernel on the card is also handed
    to ``see(kernel, args, kwargs, output)`` after its launch."""
    _observers.append(see)
    try:
        yield
    finally:
        _observers.remove(see)


def launch_counts(since: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Every hand kernel's launches by name, less ``since``'s counts."""
    since = since or {}
    return {name: k.launches - since.get(name, 0)
            for name, k in sorted(KERNELS.items())}
