"""ctypes binding of the native (C++) trie builder and oracle scanner.

``builder.cc`` and ``oracle.cc`` compile with g++ at first use into
``build/torch_kernels/libaho_native-<digest>.so``, beside the CUDA
kernels' libraries (``ops/_build.py``).  The digest covers the sources and
the flags, so an edited source is rebuilt at its next use and a stale
library is never loaded; each process compiles into a file of its own and
renames it into place, so processes that reach the first build together
never load a half-written library.  Nothing is built when the module is
imported.

The native layer is a host performance path: million-pattern builds,
bloom inserts, k-gram tables and the host oracle scan.  The native and
numpy builders emit bit-identical tables (``tests/test_torch_native.py``).
:func:`available` is False only when no C++ compiler is found and no
library was built before; the Matcher then builds with the numpy
:class:`~php_aho_corasick_tpu_torch.core.trie.TrieBuilder`.  A compile
that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.tables import CompiledAutomaton, CompressedAutomaton, state_dtype
from ..errors import AddStatus
from ..ops._build import BUILD_DIR

_DIR = Path(__file__).resolve().parent
SOURCES = ("builder.cc", "oracle.cc")
#: the Makefile's CXXFLAGS
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-fopenmp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_no_compiler = False

_i8p = ctypes.POINTER(ctypes.c_uint8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u32p = ctypes.POINTER(ctypes.c_uint32)


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"libaho_native-{h.hexdigest()[:12]}.so"


def build(out: Path, cxx: str) -> None:
    """Compile the library into ``out``; raises with the compiler's
    output when the compile fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, *(str(_DIR / s) for s in SOURCES), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed to build the native library:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.aho_builder_new.restype = ctypes.c_void_p
    lib.aho_builder_new.argtypes = [ctypes.c_int]
    lib.aho_builder_free.argtypes = [ctypes.c_void_p]
    lib.aho_builder_add.restype = ctypes.c_int
    lib.aho_builder_add.argtypes = [ctypes.c_void_p, _i8p, ctypes.c_int64]
    lib.aho_builder_compile.restype = ctypes.c_int
    lib.aho_builder_compile.argtypes = [ctypes.c_void_p]
    for name in ("aho_n_states", "aho_emit_size", "aho_final_start",
                 "aho_n_patterns"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    for name in ("aho_n_classes", "aho_max_len"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.aho_export.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, _i64p, _i32p, _i32p, _i32p
    ]
    lib.aho_builder_compile_compressed.restype = ctypes.c_int
    lib.aho_builder_compile_compressed.argtypes = [ctypes.c_void_p]
    for name in ("aho_comp_n_dense", "aho_comp_dense_final_start"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.aho_export_compressed.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, _i32p, _i32p, _i64p, _i32p,
        _i32p, _i32p,
    ]
    lib.aho_builder_add_batch.argtypes = [
        ctypes.c_void_p, _i8p, _i64p, ctypes.c_int64, _i32p
    ]
    lib.aho_scatter_or.argtypes = [_u32p, _i64p, _u32p, ctypes.c_int64]
    lib.aho_scatter_or_bit.argtypes = [_u32p, _i64p, ctypes.c_int64]
    lib.aho_kgram_build.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, _i32p,
    ]
    for name, tp in (("aho_oracle_scan", _i32p), ("aho_oracle_scan16", _i16p)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            tp, ctypes.c_int, _i32p, ctypes.c_int64, _i8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _i64p, _i32p, ctypes.c_int64, _i64p,
        ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None when it is not
    built and no g++ is found."""
    global _lib, _no_compiler
    with _lock:
        if _lib is None and not _no_compiler:
            path = library_path()
            if not path.exists():
                cxx = shutil.which("g++")
                if cxx is None:
                    _no_compiler = True
                    return None
                build(path, cxx)
            _lib = _declare(ctypes.CDLL(str(path)))
        return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: no g++ found")
    return lib


def available() -> bool:
    return _load() is not None


def loaded_path() -> str:
    """The file of the loaded library (built first if needed)."""
    return _require()._name


class NativeTrieBuilder:
    """Drop-in analog of :class:`core.trie.TrieBuilder` + ``compile_trie``
    backed by the C++ library."""

    def __init__(self, max_pattern_length: int = 1024) -> None:
        lib = _require()
        self._lib = lib
        self._h = ctypes.c_void_p(lib.aho_builder_new(max_pattern_length))
        self.closed = False

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.aho_builder_free(h)
            self._h = None

    @property
    def n_states(self) -> int:
        return int(self._lib.aho_n_states(self._h))

    def add(self, pattern: bytes) -> AddStatus:
        if self.closed:
            return AddStatus.TRIE_CLOSED
        buf = (ctypes.c_uint8 * len(pattern)).from_buffer_copy(pattern) \
            if pattern else (ctypes.c_uint8 * 1)()
        st = self._lib.aho_builder_add(
            self._h, ctypes.cast(buf, _i8p), len(pattern)
        )
        return AddStatus(st)

    def add_batch(self, patterns: Sequence[bytes]) -> List[AddStatus]:
        """One ctypes crossing for the whole batch (per-pattern ``add``
        calls cost seconds of marshaling alone at 1M patterns).  Same
        statuses, same insertion order."""
        if self.closed:
            return [AddStatus.TRIE_CLOSED] * len(patterns)
        if not patterns:
            return []
        flat = np.frombuffer(b"".join(patterns), dtype=np.uint8)
        if flat.size == 0:
            flat = np.zeros(1, np.uint8)
        lens = np.fromiter(
            (len(p) for p in patterns), np.int64, len(patterns)
        )
        statuses = np.empty(len(patterns), dtype=np.int32)
        self._lib.aho_builder_add_batch(
            self._h,
            flat.ctypes.data_as(_i8p),
            lens.ctypes.data_as(_i64p),
            len(patterns),
            statuses.ctypes.data_as(_i32p),
        )
        return [AddStatus(int(s)) for s in statuses]

    def compile(self, allow_int16: bool = True) -> CompiledAutomaton:
        lib = self._lib
        self.closed = True
        rc = lib.aho_builder_compile(self._h)
        if rc != 0:
            raise RuntimeError(f"native compile failed: {rc}")
        S = lib.aho_n_states(self._h)
        C = lib.aho_n_classes(self._h)
        E = lib.aho_emit_size(self._h)
        P = lib.aho_n_patterns(self._h)
        table = np.empty((S, C), dtype=np.int32)
        byte_class = np.empty(256, dtype=np.int32)
        emit_start = np.empty(S + 1, dtype=np.int64)
        emit_pats = np.empty(max(E, 1), dtype=np.int32)
        pat_lens = np.empty(max(P, 1), dtype=np.int32)
        state_depth = np.empty(S, dtype=np.int32)
        lib.aho_export(
            self._h,
            table.ctypes.data_as(_i32p),
            byte_class.ctypes.data_as(_i32p),
            emit_start.ctypes.data_as(_i64p),
            emit_pats.ctypes.data_as(_i32p),
            pat_lens.ctypes.data_as(_i32p),
            state_depth.ctypes.data_as(_i32p),
        )
        dt = state_dtype(int(S), allow_int16)
        return CompiledAutomaton(
            table=table.astype(dt, copy=False),
            byte_class=byte_class,
            emit_start=emit_start,
            emit_pats=emit_pats[:E],
            pat_lens=pat_lens[:P],
            state_depth=state_depth,
            final_start=int(lib.aho_final_start(self._h)),
            max_len=int(lib.aho_max_len(self._h)),
        )

    def compile_compressed(self) -> CompressedAutomaton:
        """Compile into the compressed (dense bank + single-exception
        rows) layout — bit-identical to
        ``core.automaton.compile_trie_compressed``."""
        lib = self._lib
        self.closed = True
        rc = lib.aho_builder_compile_compressed(self._h)
        if rc != 0:
            raise RuntimeError(
                "compressed compile failed: dense bank exceeds the meta "
                "packing range; use the dense table format"
            )
        S = lib.aho_n_states(self._h)
        C = lib.aho_n_classes(self._h)
        D = lib.aho_comp_n_dense(self._h)
        E = lib.aho_emit_size(self._h)
        P = lib.aho_n_patterns(self._h)
        dense_table = np.empty((D, C), dtype=np.int32)
        meta = np.empty(max(S - D, 1), dtype=np.int32)
        exc_target = np.empty(max(S - D, 1), dtype=np.int32)
        byte_class = np.empty(256, dtype=np.int32)
        emit_start = np.empty(S + 1, dtype=np.int64)
        emit_pats = np.empty(max(E, 1), dtype=np.int32)
        pat_lens = np.empty(max(P, 1), dtype=np.int32)
        state_depth = np.empty(S, dtype=np.int32)
        lib.aho_export_compressed(
            self._h,
            dense_table.ctypes.data_as(_i32p),
            meta.ctypes.data_as(_i32p),
            exc_target.ctypes.data_as(_i32p),
            byte_class.ctypes.data_as(_i32p),
            emit_start.ctypes.data_as(_i64p),
            emit_pats.ctypes.data_as(_i32p),
            pat_lens.ctypes.data_as(_i32p),
            state_depth.ctypes.data_as(_i32p),
        )
        return CompressedAutomaton(
            dense_table=dense_table,
            meta=meta[: S - D],
            exc_target=exc_target[: S - D],
            byte_class=byte_class,
            emit_start=emit_start,
            emit_pats=emit_pats[:E],
            pat_lens=pat_lens[:P],
            state_depth=state_depth,
            dense_final_start=int(lib.aho_comp_dense_final_start(self._h)),
            final_start=int(lib.aho_final_start(self._h)),
            max_len=int(lib.aho_max_len(self._h)),
        )


def build_native(
    patterns: Sequence[bytes],
    max_pattern_length: int = 1024,
    allow_int16: bool = True,
) -> Tuple[CompiledAutomaton, List[AddStatus]]:
    """Build + compile in one call. Returns (automaton, per-pattern status)."""
    b = NativeTrieBuilder(max_pattern_length)
    statuses = [b.add(p) for p in patterns]
    return b.compile(allow_int16), statuses


def scatter_or(words: np.ndarray, idx: np.ndarray, bits: np.ndarray) -> None:
    """In-place ``words[idx] |= bits`` (uint32).  ``np.bitwise_or.at``
    runs ~100 ns an element, 10+ s for the 12M-entry signature blooms;
    the C++ loop is a plain store stream.  Numpy when the library is
    unavailable."""
    lib = _load()
    assert words.dtype == np.uint32 and words.flags.c_contiguous
    if lib is None:
        np.bitwise_or.at(words, idx, bits)
        return
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    bits = np.ascontiguousarray(
        np.broadcast_to(bits, idx.shape), dtype=np.uint32
    )
    lib.aho_scatter_or(
        words.ctypes.data_as(_u32p),
        idx.ctypes.data_as(_i64p),
        bits.ctypes.data_as(_u32p),
        idx.shape[0],
    )


def scatter_or_bit(words: np.ndarray, slots: np.ndarray) -> None:
    """In-place bit-bloom insert: ``words[slots >> 5] |= 1 << (slots &
    31)`` (uint32 words).  The numpy form, when the library is
    unavailable, does the same."""
    lib = _load()
    assert words.dtype == np.uint32 and words.flags.c_contiguous
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    if lib is None:
        np.bitwise_or.at(
            words, slots >> 5,
            np.uint32(1) << (slots & 31).astype(np.uint32),
        )
        return
    lib.aho_scatter_or_bit(
        words.ctypes.data_as(_u32p),
        slots.ctypes.data_as(_i64p),
        slots.shape[0],
    )


def kgram_build(auto: CompiledAutomaton, k: int) -> np.ndarray:
    """Compose the packed k-gram table in C++ (see models/kgram_dfa.py)."""
    lib = _require()
    S, C = auto.table.shape
    table1 = np.ascontiguousarray(auto.table, dtype=np.int32)
    out = np.empty(S * C**k, dtype=np.int32)
    lib.aho_kgram_build(
        table1.ctypes.data_as(_i32p),
        S,
        C,
        auto.final_start,
        k,
        out.ctypes.data_as(_i32p),
    )
    return out


def oracle_scan(
    auto: CompiledAutomaton,
    text: bytes,
    init_state: int = 0,
    emit_from: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Scalar scan via the C++ oracle. Returns (positions, states, carry)."""
    lib = _require()
    n = len(text)
    cap = max(1024, n // 8)
    data = np.frombuffer(text, dtype=np.uint8) if n else np.zeros(1, np.uint8)
    byte_class = np.ascontiguousarray(auto.byte_class, dtype=np.int32)
    table = np.ascontiguousarray(auto.table)
    if table.dtype == np.int16:
        fn, tp = lib.aho_oracle_scan16, _i16p
    else:
        fn, tp = lib.aho_oracle_scan, _i32p
    while True:
        out_pos = np.empty(cap, dtype=np.int64)
        out_state = np.empty(cap, dtype=np.int32)
        carry = ctypes.c_int64(0)
        found = fn(
            table.ctypes.data_as(tp),
            auto.n_classes,
            byte_class.ctypes.data_as(_i32p),
            auto.final_start,
            data.ctypes.data_as(_i8p),
            n,
            init_state,
            emit_from,
            out_pos.ctypes.data_as(_i64p),
            out_state.ctypes.data_as(_i32p),
            cap,
            ctypes.byref(carry),
        )
        if found <= cap:
            return out_pos[:found], out_state[:found], int(carry.value)
        cap = int(found)
