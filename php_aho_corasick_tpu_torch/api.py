"""The :class:`Matcher` of the PyTorch port.

Counterpart of the JAX package's ``api.py``, for what this port covers so
far: the build lifecycle (``add_patterns`` / ``finalize`` / ``close``),
the reference-schema match records (:meth:`Matcher.match`,
:meth:`Matcher.match_many`), :meth:`Matcher.device_corpus` and the
columnar scans (:meth:`Matcher.match_arrays`,
:meth:`Matcher.match_arrays_many`, the cross-batch double buffer
:meth:`Matcher.match_arrays_stream`, and the cold-corpus pipeline that
``match_arrays`` takes over a fresh document list), the chunked stream
(:meth:`Matcher.stream`, :meth:`Matcher.iter_matches`) and
search-and-replace (:meth:`Matcher.replace`,
:meth:`Matcher.replace_stream`).  Columnar results are ``doc``,
``pos`` (exclusive byte end), ``start_postion`` (sic — the reference
API's field name) and ``pattern`` (index into the accepted patterns), in
reference emission order.

Scans go to one of four engines (:meth:`Matcher._pick_engine`): the
sampled cascade for large scans, the tile engine
(``csrc/scan_states_tile.cu``) for small automata, the k-gram DFA (k
bytes a gather) for large scans, and the 1-gram DFA otherwise; scans of
at most ``host_scan_threshold`` bytes run on the host
(``backend="auto"``).  A forced ``engine="cascade"`` also serves the
anchored plan, whose candidates are verified on the host
(``CascadeModel.run_arrays``).  Needle sets whose dense ``[S, C]`` table
would exceed ``dense_table_max_bytes`` finalize to the compressed table
(:attr:`Matcher.table_format`), served by the sampled cascade or the
compressed DFA.

A matcher runs on CUDA unless the caller passes ``device="cpu"``.  Its
scans shard over a data mesh (``parallel/mesh.py``: every visible card,
or ``n`` shards of one device inside ``parallel.mesh.local_shards(n)``)
when ``config.auto_shard`` is set and the mesh has more than one shard,
or for a handle from ``device_corpus(docs, shard=True)``: each shard runs
the single-device chain on its row block (``parallel/shard_scan.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import DEFAULT_CONFIG, ScanConfig
from .core import TrieBuilder, compile_trie, empty_automaton
from .errors import AddStatus, AhoError, warn
from .models.dense_dfa import DenseDfaModel
from .ops.matches import (
    PackedRows,
    expand_matches_arrays,
    expand_matches_kgram_arrays,
    pack_documents,
)
from .patterns import Pattern, parse_batch
from .utils import next_pow2 as _next_pow2
from .utils.profiling import span, wait

Haystack = Union[str, bytes, bytearray]

_UNSET = object()


class StateError(AhoError):
    """Operation on a closed matcher, or a lifecycle-order violation
    (reference: PHP warning + ``false``)."""


def resolve_device(device=None) -> torch.device:
    """The device a matcher runs on: CUDA by default, the CPU only when
    asked for.  Raises ``RuntimeError`` when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceCorpus:
    """Device-resident packed corpus handle: :meth:`Matcher.device_corpus`
    pays ``pack_documents`` + the host->device copy once, and every scan
    against the handle re-reads the resident bytes.  The corpus word
    phases of the fused filter are cached per handle the first time a
    scan needs them.

    A sharded handle (``mesh`` set) holds this process's row blocks:
    ``chunks_d``, ``lengths_d`` and ``emit_from_d`` are then lists with
    one tensor per local shard, on that shard's device."""

    def __init__(self, packed: PackedRows, chunks_d, lengths_d,
                 emit_from_d, n_docs: int, total_bytes: int,
                 chunk_len: int, mesh=None):
        self.packed = packed
        self.chunks_d = chunks_d
        self.lengths_d = lengths_d
        self.emit_from_d = emit_from_d
        self.n_docs = n_docs
        self.total_bytes = total_bytes
        self.chunk_len = chunk_len
        #: parallel.mesh.DataMesh of a sharded handle; None: one device
        self.mesh = mesh
        self._phase_cache: dict = {}

    @property
    def device(self) -> torch.device:
        if self.mesh is not None:
            return self.mesh.home
        return self.chunks_d.device

    def fused_phases(self, cascade_model):
        """Lazily cached corpus word phases of the fused filter
        (ops/filter_torch.fused_phase_grid), one corpus-sized residency
        per distinct stride; ``None`` when the plan's alignment gate
        fails."""
        if cascade_model is None:
            return None
        p = cascade_model.plan
        L = self.packed.row_len
        if (
            p.mode != "sampled"
            or not p.stride
            or p.stride % 4
            or L % p.stride
            or cascade_model.bloom_impl() != "pallas_vmem"
        ):
            return None
        key = p.stride
        if key not in self._phase_cache:
            from .ops.filter_torch import fused_phase_grid

            spc = p.stride // 4
            self._phase_cache[key] = (
                fused_phase_grid(self.chunks_d, spc=spc)
                if self.mesh is None
                else [fused_phase_grid(c, spc=spc) for c in self.chunks_d]
            )
        return self._phase_cache[key]

    def dev_inputs_for(self, cascade_model):
        """``dev_inputs`` extended with the cached fused-filter phases
        (consumed by ``CascadeModel.run_arrays``)."""
        return (
            self.chunks_d, self.lengths_d, self.emit_from_d,
            self.fused_phases(cascade_model),
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"DeviceCorpus(docs={self.n_docs}, bytes={self.total_bytes}, "
            f"chunk_len={self.chunk_len}, device={self.device}, "
            f"mesh={self.mesh})"
        )


def _as_bytes(h: Haystack) -> bytes:
    if isinstance(h, str):
        return h.encode("utf-8")
    return bytes(h)


def _corpus_attrs(corpus) -> dict:
    """What a ``call`` span notes of its corpus: a resident handle's bytes
    and documents, a handle list's bytes and length, a document list's
    length."""
    if isinstance(corpus, DeviceCorpus):
        return {"bytes": corpus.total_bytes, "docs": corpus.n_docs}
    if isinstance(corpus, (list, tuple)):
        if corpus and isinstance(corpus[0], DeviceCorpus):
            return {"bytes": sum(h.total_bytes for h in corpus),
                    "handles": len(corpus)}
        return {"docs": len(corpus)}
    return {}


def _scan_call(method):
    """The root ``call`` span around a public scan entry."""

    @functools.wraps(method)
    def call(self, corpus, *args, **kwargs):
        with span("call", **_corpus_attrs(corpus)):
            return method(self, corpus, *args, **kwargs)

    return call


def _first_groups(results: List[List[dict]]) -> List[List[dict]]:
    """Each document's records of its first matching end position only
    (the reference's callback-return abort, ``php_ahocorasick.c:588``)."""
    return [
        [r for r in recs if r["pos"] == recs[0]["pos"]] for recs in results
    ]


class Matcher:
    """Multi-pattern byte matcher on a device, or sharded over a data
    mesh."""

    def __init__(
        self,
        patterns: Optional[Sequence[Any]] = None,
        config: ScanConfig = DEFAULT_CONFIG,
        device=None,
    ) -> None:
        from .utils.logging import ScanStats

        self.config = config
        self.device = resolve_device(device)
        self._trie = self._make_builder(config)
        self._patterns: List[Pattern] = []  # accepted patterns, id = index
        self._statuses: List[AddStatus] = []
        self._auto = None
        self._model = None
        self._used_bytes: set = set()
        self._cascade = _UNSET
        self._tile = _UNSET
        self._kmodel = None
        self._fetch_stream = None  # CUDA side stream of the records fetch
        #: per-shard automaton arrays of the sharded scans, by engine and
        #: mesh: uploaded once, not once a pass
        self._sharded_dev_cache: dict = {}
        self.stats = ScanStats()
        self._finalized = False
        self._valid = True
        if patterns is not None:
            self.add_patterns(patterns)

    # ------------------------------------------------------------ build

    @staticmethod
    def _make_builder(config: ScanConfig):
        if config.prefer_native_builder:
            from . import native

            if native.available():
                return native.NativeTrieBuilder(config.max_pattern_length)
        return TrieBuilder(config.max_pattern_length)

    def add_patterns(self, specs: Sequence[Any]) -> List[AddStatus]:
        """Validate and insert a batch of pattern specs (the whole batch
        is validated before any insertion).  Returns one
        :class:`AddStatus` per spec; non-SUCCESS patterns are absent from
        the automaton."""
        if not self._valid:
            warn("add_patterns on a closed matcher")
            raise StateError("matcher is closed")
        if self._finalized:
            warn("Cannot add patterns to an already finalized automaton")
            raise StateError("automaton already finalized")
        pats = parse_batch(specs)
        if hasattr(self._trie, "add_batch"):
            # native builder: one ctypes crossing for the whole batch
            statuses = self._trie.add_batch([p.value for p in pats])
        else:
            statuses = [self._trie.add(p.value) for p in pats]
        for p, st in zip(pats, statuses):
            if st == AddStatus.SUCCESS:
                self._patterns.append(p)
                self._used_bytes.update(p.value)
        self._statuses.extend(statuses)
        return statuses

    def finalize(self) -> bool:
        """Compile the automaton. Idempotent; True only on the transition."""
        if not self._valid:
            warn("finalize on a closed matcher")
            raise StateError("matcher is closed")
        if self._finalized:
            return False
        with span("build", needles=len(self._patterns)):
            model_cls = DenseDfaModel
            if not self._patterns:
                self._auto = empty_automaton()
            elif self._use_compressed_table():
                from .core.automaton import compile_trie_compressed
                from .models.compressed_dfa import CompressedDfaModel

                if isinstance(self._trie, TrieBuilder):
                    self._auto = compile_trie_compressed(
                        self._trie, [len(p) for p in self._patterns]
                    )
                else:  # native builder (signature scale)
                    self._auto = self._trie.compile_compressed()
                model_cls = CompressedDfaModel
            elif isinstance(self._trie, TrieBuilder):
                self._auto = compile_trie(
                    self._trie,
                    [len(p) for p in self._patterns],
                    allow_int16=self.config.allow_int16_states,
                )
            else:  # native builder
                self._auto = self._trie.compile(
                    allow_int16=self.config.allow_int16_states
                )
            self._trie.closed = True
            self._model = model_cls(self._auto, self.config, self.device)
            self._finalized = True
        return True

    def _use_compressed_table(self) -> bool:
        fmt = self.config.table_format
        if fmt != "auto":
            return fmt == "compressed"
        S = self._trie.n_states
        C = len(self._used_bytes) + 1
        dtype_bytes = 2 if (self.config.allow_int16_states and S <= 32767) else 4
        return S * C * dtype_bytes > self.config.dense_table_max_bytes

    @property
    def table_format(self) -> str:
        """Resolved transition-table layout ("dense" or "compressed")."""
        from .core.tables import CompressedAutomaton

        if not self._finalized:
            self.finalize()
        return (
            "compressed"
            if isinstance(self._auto, CompressedAutomaton)
            else "dense"
        )

    # ------------------------------------------------------------ query

    @property
    def finalized(self) -> bool:
        return self._finalized

    @property
    def n_patterns(self) -> int:
        return len(self._patterns)

    @property
    def automaton(self):
        """The frozen compiled automaton (:class:`CompiledAutomaton`, or
        :class:`~.core.tables.CompressedAutomaton` for byte-dense
        signature-scale sets: see :attr:`table_format`)."""
        if not self._finalized:
            self.finalize()
        return self._auto

    @property
    def model(self):
        """The device scan model (DenseDfaModel or CompressedDfaModel)."""
        if not self._finalized:
            self.finalize()
        return self._model

    def is_valid(self) -> bool:
        return self._valid

    def describe(self) -> str:
        """Human-readable automaton summary (analog of ``ac_trie_display``,
        ``src/multifast/ahocorasick.c:304-307``)."""
        if not self._finalized:
            return f"Matcher(open, {len(self._patterns)} patterns)"
        return self.automaton.describe()

    @property
    def cascade_model(self):
        """Lazily planned cascade filter model (models/cascade.py);
        ``None`` when the pattern set is ineligible."""
        if self._cascade is _UNSET:
            from .models.cascade import CascadeModel, plan_cascade

            plan = plan_cascade(
                [p.value for p in self._patterns], self.automaton, self.config
            )
            self._cascade = (
                CascadeModel(
                    self.automaton, plan, self.config,
                    dense_model=self.model, stats=self.stats,
                    device=self.device,
                )
                if plan.eligible
                else None
            )
        return self._cascade

    @property
    def kgram_model(self):
        """Lazily built k-gram DFA model (models/kgram_dfa.py); the dense
        table format only."""
        if self._kmodel is None:
            if self.table_format == "compressed":
                raise AhoError(
                    "k-gram engine requires the dense table format"
                )
            from .models.kgram_dfa import KgramDfaModel

            self._kmodel = KgramDfaModel(
                self.automaton, self.config, self.device
            )
        return self._kmodel

    @property
    def tile_model(self):
        """Shared-memory tile DFA model (models/tile_dfa.py); ``None``
        when the automaton exceeds the tile budget or the table is
        compressed."""
        if self._tile is _UNSET:
            if self.table_format == "compressed":
                self._tile = None
                return None
            from .models.tile_dfa import TileDfaModel, tile_eligible

            self._tile = (
                TileDfaModel(self.automaton, self.config, self.device)
                if tile_eligible(self.automaton)
                else None
            )
        return self._tile

    def _pick_engine(self, total_payload: int) -> str:
        """Engine of a device scan.  A forced engine is taken as given
        (the compressed table has no k-gram or tile engine and raises for
        them).  ``auto`` takes the sampled cascade for scans of at least
        ``cascade_min_bytes`` (on a compressed table only where its
        windows verify on the device), else, on the dense table, the tile
        engine when the automaton fits it, the k-gram engine for scans of
        at least ``kgram_min_bytes`` when ``k >= 2``, else the 1-gram DFA
        (``"dfa"``: the compressed walk on a compressed table).  The same
        rule holds on every device, so the CPU runs the card's route."""
        cfg = self.config
        compressed = self.table_format == "compressed"
        if compressed and cfg.engine in ("kgram", "tile"):
            raise ValueError(
                f"engine {cfg.engine!r} requires the dense table format"
            )
        if cfg.engine in ("dfa", "kgram"):
            return cfg.engine
        if cfg.engine == "tile":
            if self.tile_model is None:
                raise ValueError(
                    "tile engine forced but automaton exceeds the tile budget"
                )
            return "tile"
        if cfg.engine == "cascade":
            if self.cascade_model is None:
                raise ValueError(
                    "cascade engine forced but pattern set is ineligible"
                )
            return "cascade"
        cm = (
            self.cascade_model
            if total_payload >= cfg.cascade_min_bytes
            else None
        )
        if (
            cm is not None
            and cm.plan.mode == "sampled"
            and (cm.device_verify_ok or not compressed)
        ):
            return "cascade"
        if compressed:
            return "dfa"
        if self.tile_model is not None:
            return "tile"
        if total_payload >= cfg.kgram_min_bytes and self.kgram_model.k >= 2:
            return "kgram"
        return "dfa"

    # ------------------------------------------------------------ scans

    def _check_open(self) -> None:
        if not self._valid:
            warn("match on a closed matcher")
            raise StateError("matcher is closed")
        if not self._finalized:
            self.finalize()

    def match(
        self,
        haystack: Haystack,
        find_all: bool = True,
        backend: Optional[str] = None,
    ) -> List[dict]:
        """Scan one haystack; returns reference-parity match record dicts.

        Automaton state is reset per call (a pattern split across two
        consecutive ``match`` calls does NOT match: the reference forces
        ``keep=0``, ``php_ahocorasick.c:745``).  With ``find_all=False``, returns only
        the records of the first matching end position
        (``php_ahocorasick.c:588``)."""
        return self.match_many([haystack], find_all=find_all, backend=backend)[0]

    @_scan_call
    def match_many(
        self,
        haystacks: Union[Sequence[Haystack], DeviceCorpus],
        find_all: bool = True,
        backend: Optional[str] = None,
    ) -> List[List[dict]]:
        """Scan many haystacks; one record list per haystack.  Accepts a
        :class:`DeviceCorpus` handle in place of the haystack sequence.
        ``backend`` overrides ``config.backend`` for this call."""
        self._check_open()
        if isinstance(haystacks, DeviceCorpus):
            dc = haystacks
            results = [[] for _ in range(dc.n_docs)]
            if self._auto.n_patterns == 0:
                return results
            engine, docs_a, ends_a, pids_a = self._scan_handle_arrays(dc)
            self._emit_records(docs_a, ends_a, pids_a, results)
            self.stats.record(
                engine, str(self.device), dc.total_bytes,
                int(docs_a.shape[0]),
            )
            return results if find_all else _first_groups(results)
        docs = [_as_bytes(h) for h in haystacks]
        results: List[List[dict]] = [[] for _ in docs]
        if self._auto.n_patterns == 0 or not docs:
            return results
        be = backend or self.config.backend
        total = sum(len(d) for d in docs)
        if be == "host" or (
            be == "auto" and total <= self.config.host_scan_threshold
        ):
            self._scan_host(docs, results)
            self.stats.record("scalar", "host", total, sum(map(len, results)))
        else:
            # oversized corpora go in several launches (documents are
            # independent, so this is exact)
            engine = "-"
            for g in self._launch_groups(docs, self.config.max_launch_bytes):
                engine, docs_a, ends_a, pids_a = self._scan_device_arrays(
                    [docs[i] for i in g]
                )
                sub = [[] for _ in g]
                self._emit_records(docs_a, ends_a, pids_a, sub)
                for i, r in zip(g, sub):
                    results[i] = r
            self.stats.record(
                engine, str(self.device), total, sum(map(len, results))
            )
        return results if find_all else _first_groups(results)

    def device_corpus(
        self, haystacks: Sequence[Haystack], shard: Optional[bool] = None
    ) -> DeviceCorpus:
        """Pack + upload a corpus once, returning a resident
        :class:`DeviceCorpus` accepted by :meth:`match_many`,
        :meth:`match_arrays` and :meth:`match_arrays_many`.

        ``shard``: split the packed rows over the data mesh
        (``parallel/mesh.data_mesh``), so every scan against the handle
        runs per shard (``parallel/shard_scan.py``).  Default: shard when
        ``config.auto_shard`` is set and the mesh has more than one
        shard; a mesh of one shard never shards."""
        if not self._valid:
            warn("device_corpus on a closed matcher")
            raise StateError("matcher is closed")
        if not self._finalized:
            self.finalize()
        from .parallel.mesh import data_mesh

        mesh = data_mesh(device=self.device)
        use_mesh = (
            shard if shard is not None else self.config.auto_shard
        ) and len(mesh) > 1
        docs = [_as_bytes(h) for h in haystacks]
        total = sum(map(len, docs))
        if total > self.config.max_launch_bytes:
            raise AhoError(
                f"device corpus of {total} bytes exceeds "
                f"max_launch_bytes={self.config.max_launch_bytes}; "
                "split into multiple handles"
            )
        return self._upload(docs, mesh if use_mesh else None)

    def _auto_mesh(self):
        """The data mesh of a scan over a document list: the default mesh
        where ``config.auto_shard`` is set and it has more than one shard,
        else None (one device)."""
        if not self.config.auto_shard:
            return None
        from .parallel.mesh import data_mesh

        mesh = data_mesh(device=self.device)
        return mesh if len(mesh) > 1 else None

    def _pack(self, docs: List[bytes], n_shards: int = 1) -> PackedRows:
        """Halo-overlapped rows of ``docs``; the row count is padded to a
        multiple of ``lcm(batch_pad, n_shards)``, which sets the shard
        boundaries of a sharded scan."""
        import math

        halo = max(self._auto.max_len - 1, 0)
        with span("pack", docs=len(docs), shards=n_shards):
            return pack_documents(
                docs, self._pack_chunk_len(), halo,
                math.lcm(self.config.batch_pad, n_shards),
                row_align=self._row_align(),
            )

    def _upload(self, docs: List[bytes], mesh=None) -> DeviceCorpus:
        """Pack ``docs`` into halo-overlapped rows and copy them to the
        device, or this process's row blocks to their shards' devices
        when ``mesh`` is given.  On CUDA the rows go through pinned host
        memory and the copies are enqueued without waiting, so the host
        returns while earlier work (a previous slice's chain) still
        runs."""
        n_shards = len(mesh) if mesh is not None else 1
        total = sum(map(len, docs))
        with span("upload", bytes=total, docs=len(docs), shards=n_shards):
            packed = self._pack(docs, n_shards)
            pin = self.device.type == "cuda"
            if mesh is not None:
                from .parallel.mesh import row_sharding

                def put(x):
                    return row_sharding(mesh, x, pin=pin)
            else:
                def put(x):
                    t = torch.from_numpy(x)
                    return (t.pin_memory() if pin else t).to(
                        self.device, non_blocking=True
                    )

            return DeviceCorpus(
                packed, put(packed.chunks), put(packed.lengths),
                put(packed.emit_from), len(docs), total,
                self.config.chunk_len, mesh=mesh,
            )

    def _pack_chunk_len(self) -> int:
        """Chunk row length used for packing: ``chunk_len`` rounded up to
        a multiple of the sampled cascade's stride (when cell-aligned)."""
        base = self.config.chunk_len
        cm = self.cascade_model
        if cm is not None and cm.plan.mode == "sampled":
            s = cm.plan.stride
            if s and s % 4 == 0 and base % s:
                return ((base + s - 1) // s) * s
        return base

    def _row_align(self) -> int:
        """Row-length alignment for ``pack_documents``: ``lcm(stride,
        128)`` when the fused filter applies, so the packed ``L`` always
        satisfies its ``stride | L`` gate."""
        import math

        cm = self.cascade_model
        if cm is not None and cm.plan.mode == "sampled":
            s = cm.plan.stride
            if s and s % 4 == 0:
                return math.lcm(s, 128)
        return 128

    def _check_handle(self, dc: DeviceCorpus) -> None:
        if dc.device != self.device:
            raise ValueError(
                f"corpus handle lives on {dc.device}, matcher on {self.device}"
            )

    def _scan_device_arrays(self, docs: List[bytes]):
        """Device scan of one launch group; returns ``(engine, doc_ids,
        end_positions, pattern_ids)`` in reference emission order.  With
        ``auto_shard`` and a mesh of more than one shard the rows are
        sharded, apart from a cascade on the compressed table, which the
        reference serves on one device (its rows still padded for the
        mesh)."""
        mesh = self._auto_mesh()
        if mesh is None:
            return self._scan_handle_arrays(self._upload(docs))
        if (
            self.table_format == "compressed"
            and self._pick_engine(sum(map(len, docs))) == "cascade"
        ):
            arrays = self.cascade_model.run_arrays(
                self._pack(docs, len(mesh)), self.config.match_capacity
            )
            return ("cascade",) + tuple(arrays)
        return self._scan_handle_arrays(self._upload(docs, mesh))

    def _scan_handle_arrays(self, dc: DeviceCorpus):
        """Engine dispatch over a resident corpus handle; returns
        ``(engine, doc_ids, end_positions, pattern_ids)`` in reference
        emission order."""
        self._check_handle(dc)
        engine = self._pick_engine(dc.total_bytes)
        capacity = self.config.match_capacity
        if dc.mesh is not None:
            if engine == "cascade":
                arrays = self._run_sharded_cascade(dc, capacity)
                return ("cascade",) + tuple(arrays)
            sharded_engine = (
                "compressed"
                if engine == "dfa" and self.table_format == "compressed"
                else engine
            )
            idx_np, aux_np, n = self._run_sharded(dc, capacity, sharded_engine)
            if engine == "kgram":
                arrays = expand_matches_kgram_arrays(
                    self._auto, dc.packed, self.kgram_model.k, idx_np,
                    aux_np, n,
                )
            else:
                arrays = expand_matches_arrays(
                    self._auto, dc.packed, idx_np, aux_np, n
                )
            return (engine,) + tuple(arrays)
        if engine == "cascade":
            cm = self.cascade_model
            arrays = cm.run_arrays(
                dc.packed, capacity, dev_inputs=dc.dev_inputs_for(cm)
            )
            return ("cascade",) + tuple(arrays)
        if engine == "tile":
            model = self.tile_model
        elif engine == "kgram":
            model = self.kgram_model
        else:
            model = self._model
        while True:
            idx, sts, n, _ = model.scan_compact_device(
                dc.chunks_d, dc.lengths_d, dc.emit_from_d, None, capacity
            )
            with wait(self.stats, n):
                n = int(n)
            if n <= capacity:
                break
            capacity = _next_pow2(n)
        # one fetch of the occupied prefix of both buffers
        flat = torch.cat([idx[:n], sts[:n]])
        with wait(self.stats, flat):
            flat = flat.cpu().numpy()
        if engine == "kgram":
            arrays = expand_matches_kgram_arrays(
                self._auto, dc.packed, model.k, flat[:n], flat[n:], n
            )
        else:
            arrays = expand_matches_arrays(
                self._auto, dc.packed, flat[:n], flat[n:], n
            )
        return (engine,) + tuple(arrays)

    @staticmethod
    def _launch_groups(docs: List[bytes], limit: int) -> List[List[int]]:
        """Document indices cut into consecutive groups of at most
        ``limit`` bytes (a larger document is a group of its own)."""
        groups: List[List[int]] = []
        group: List[int] = []
        group_bytes = 0
        for i, d in enumerate(docs):
            if group and group_bytes + len(d) > limit:
                groups.append(group)
                group, group_bytes = [], 0
            group.append(i)
            group_bytes += len(d)
        if group:
            groups.append(group)
        return groups

    @_scan_call
    def match_arrays(
        self,
        haystacks: Union[Sequence[Haystack], DeviceCorpus],
        find_all: bool = True,
    ) -> dict:
        """Columnar scan output: ``{"doc", "pos", "start_postion",
        "pattern"}`` int64 arrays in reference emission order.  A
        document list is scanned in groups of at most
        ``max_launch_bytes``; with ``backend="auto"`` a group of at most
        ``host_scan_threshold`` bytes runs on the host."""
        self._check_open()
        if isinstance(haystacks, DeviceCorpus):
            dc = haystacks
            if self._auto.n_patterns == 0:
                z = np.zeros(0, np.int64)
                return self._arrays_result(dc.total_bytes, z, z, z, find_all)
            _, docs_a, ends_a, pids_a = self._scan_handle_arrays(dc)
            return self._arrays_result(
                dc.total_bytes, docs_a, ends_a, pids_a, find_all
            )
        docs = [_as_bytes(h) for h in haystacks]
        fresh = self._match_arrays_fresh_pipelined(docs, find_all)
        if fresh is not None:
            return fresh
        parts = []
        if self._auto.n_patterns > 0:
            limit = self.config.max_launch_bytes
            parts = [self._group_arrays(docs, g)
                     for g in self._launch_groups(docs, limit)]
        if parts:
            docs_a, ends_a, pids_a = (
                np.concatenate([p[k] for p in parts]) for k in range(3)
            )
        else:
            docs_a = ends_a = pids_a = np.zeros(0, np.int64)
        return self._arrays_result(
            sum(map(len, docs)), docs_a, ends_a, pids_a, find_all
        )

    def _group_arrays(self, docs: List[bytes], group: List[int]):
        """One launch group -> (global_doc_ids, ends, pids)."""
        sub = [docs[i] for i in group]
        total = sum(map(len, sub))
        # backend="host" forces the host path at ANY size (same contract as
        # match_many); "auto" routes small groups to the host scalar scan
        if self.config.backend == "host" or (
            self.config.backend == "auto"
            and total <= self.config.host_scan_threshold
        ):
            from .ops.matches import csr_expand

            auto = self._auto
            dparts, eparts, pparts = [], [], []
            for gi, d in zip(group, sub):
                if not d:
                    continue
                positions, states, _ = self._scan_host_one(d)
                rec_of, pids = csr_expand(auto, states.astype(np.int64))
                dparts.append(np.full(pids.shape[0], gi, np.int64))
                eparts.append(positions.astype(np.int64)[rec_of] + 1)
                pparts.append(pids)
            if not dparts:
                z = np.zeros(0, np.int64)
                return z, z, z
            return (
                np.concatenate(dparts),
                np.concatenate(eparts),
                np.concatenate(pparts),
            )
        _, docs_a, ends_a, pids_a = self._scan_device_arrays(sub)
        gmap = np.asarray(group, dtype=np.int64)
        return gmap[docs_a], ends_a, pids_a

    def _scan_host_one(self, doc: bytes):
        from . import native
        from .core.tables import CompressedAutomaton

        if not isinstance(self._auto, CompressedAutomaton) and native.available():
            return native.oracle_scan(self._auto, doc)
        data = np.frombuffer(doc, dtype=np.uint8)
        return self._model.scan_host(data)

    def _scan_host(self, docs: List[bytes], results: List[List[dict]]) -> None:
        auto = self._auto
        for d, doc in enumerate(docs):
            if not doc:
                continue
            positions, states, _ = self._scan_host_one(doc)
            out = results[d]
            for t, s in zip(positions, states):
                lo, hi = auto.emit_start[s], auto.emit_start[s + 1]
                for pid in auto.emit_pats[lo:hi]:
                    out.append(self._format(int(pid), int(t) + 1))

    @_scan_call
    def match_arrays_many(
        self,
        handles: Sequence[DeviceCorpus],
        find_all: bool = True,
    ) -> List[dict]:
        """Pipelined columnar scan of several resident corpora: every
        device chain is enqueued back to back with no host fetch in
        between, and all occupancy counts come back in one trailing
        fetch.  Falls back to sequential :meth:`match_arrays` when the
        cascade records path is unavailable (recorded in
        ``stats.records_fallbacks``).  Returns one :meth:`match_arrays`-
        style dict per handle."""
        self._check_open()
        handles = list(handles)
        if not handles:
            return []
        if self._auto.n_patterns == 0:
            return [self.match_arrays(h, find_all) for h in handles]
        cm = self.cascade_model
        if cm is None or cm.plan.mode != "sampled" or not cm.records_ok:
            # exact, but not silent: these sets serve at sequential speed
            reason = (
                "no cascade plan" if cm is None
                else f"plan mode {cm.plan.mode!r}" if cm.plan.mode != "sampled"
                else f"records gate: win_len={cm.win_len} (> 31) or "
                     f"states={self._auto.n_states} (>= 2^26) or no "
                     "device verify"
            )
            self.stats.record_records_fallback(reason)
            return [self.match_arrays(h, find_all) for h in handles]
        if not all(
            self._pick_engine(h.total_bytes) == "cascade" for h in handles
        ):
            self.stats.record_records_fallback(
                "engine auto-selection routed a handle off the cascade"
            )
            return [self.match_arrays(h, find_all) for h in handles]
        for h in handles:
            self._check_handle(h)
        if all(h.mesh is not None for h in handles):
            return self._records_batch_sharded_finish(
                *self._records_batch_sharded_dispatch(handles, cm), find_all
            )
        if any(h.mesh is not None for h in handles):
            # mixed residency: each handle on its own fast path
            return [self.match_arrays(h, find_all) for h in handles]
        return self._records_batch_finish(
            *self._records_batch_dispatch(handles, cm), find_all
        )

    def _match_arrays_fresh_pipelined(self, docs, find_all):
        """Cold-corpus double buffering: slice a fresh document list into
        ``fresh_slice_bytes`` pieces and drive them through
        :meth:`match_arrays_stream`, so slice ``k+1``'s host packing and
        host->device upload overlap slice ``k``'s device scan (and slice
        ``k-1``'s host emission).  Returns the merged columnar dict, or
        None when the pipeline does not apply (small input, no
        records-path plan, or a mesh of more than one shard under
        ``auto_shard``: those keep the grouped path)."""
        cm = self.cascade_model
        slice_bytes = min(
            self.config.fresh_slice_bytes,
            self.config.max_launch_bytes // 2,
        )
        total = sum(map(len, docs))
        if (
            cm is None
            or cm.plan.mode != "sampled"
            or not cm.records_ok
            or len(docs) < 2
            or total < 2 * slice_bytes
            or max(map(len, docs)) > slice_bytes
            or self._auto_mesh() is not None
            or self._pick_engine(total) != "cascade"
        ):
            return None

        slices = [(g[0], g[-1] + 1)  # (doc_lo, doc_hi)
                  for g in self._launch_groups(docs, slice_bytes)]

        def batches():
            for s_lo, s_hi in slices:
                # pack + upload run here, i.e. while the PREVIOUS slice's
                # chains execute on the device (enqueued, not waited for)
                yield [self.device_corpus(docs[s_lo:s_hi])]

        docs_l, ends_l, pids_l = [], [], []
        for (s_lo, _), res in zip(
            slices, self.match_arrays_stream(batches(), find_all)
        ):
            r = res[0]
            docs_l.append(r["doc"] + s_lo)  # globalize doc indices
            ends_l.append(r["pos"])
            pids_l.append(r["pattern"])
        docs_a = np.concatenate(docs_l)
        ends_a = np.concatenate(ends_l)
        pids_a = np.concatenate(pids_l)
        starts_a = ends_a - self._auto.pat_lens[pids_a]
        # bytes/matches were already counted per slice by _arrays_result;
        # only mark which path served the call (a second record here
        # would double-count the whole corpus)
        self.stats.last_engine = "cascade-fresh"
        return {
            "doc": docs_a,
            "pos": ends_a,
            "start_postion": starts_a,  # sic: reference API typo
            "pattern": pids_a,
        }

    def match_arrays_stream(self, handle_batches, find_all: bool = True):
        """Generator over batches of resident handles: yields one
        :meth:`match_arrays_many`-style result list per batch, with batch
        ``k+1``'s device chains enqueued BEFORE batch ``k``'s records are
        fetched and expanded on the host, so the device computes the next
        batch while the host emits the previous one.  Results equal
        :meth:`match_arrays_many` called per batch; a batch off the
        records path goes through it, in order."""
        self._check_open()
        cm = self.cascade_model

        def finish(pending):
            # a batch's finish alone is a call (no span is open at a yield)
            with span("call", handles=len(pending[0])):
                return self._records_batch_finish(*pending, find_all)

        prev = None
        for batch in handle_batches:
            batch = list(batch)
            fast = (
                batch
                and cm is not None
                and cm.plan.mode == "sampled"
                and cm.records_ok
                and all(h.mesh is None for h in batch)
                and all(
                    self._pick_engine(h.total_bytes) == "cascade"
                    for h in batch
                )
            )
            if not fast:
                if prev is not None:
                    yield finish(prev)
                    prev = None
                yield self.match_arrays_many(batch, find_all)
                continue
            for h in batch:
                self._check_handle(h)
            # a batch's call: its dispatch and the previous batch's finish
            with span("call", handles=len(batch)):
                cur = self._records_batch_dispatch(batch, cm)
                done = (self._records_batch_finish(*prev, find_all)
                        if prev is not None else None)
            if prev is not None:
                yield done
            prev = cur
        if prev is not None:
            yield finish(prev)

    def _records_batch_dispatch(self, handles, cm):
        """Enqueue the speculative records chains for a batch — device
        work only, no host fetch.  On CUDA the batch's occupancy counts
        are then copied into pinned host memory without waiting, and an
        event marks the end of this batch's work: its finish waits for
        that event alone, not for batches enqueued after it.  The
        capacities the chains ran with go to the finish, which judges
        every handle's overflow against them."""
        cap_a = max(cm._cap_hits, 256)
        cap_r = max(cm._cap_flagged, 256)
        cap_c = cm._cap_coarse
        with span("dispatch", handles=len(handles)):
            outs = [
                cm.launch_device_records(
                    h.chunks_d, h.lengths_d, h.emit_from_d, cap_a, cap_r,
                    phase_g=h.fused_phases(cm),
                )
                for h in handles
            ]
            counts = torch.stack([s for o in outs for s in o[2:5]])
            ready = None
            if counts.is_cuda:
                host = torch.empty(counts.shape, dtype=counts.dtype,
                                   pin_memory=True)
                counts = host.copy_(counts, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
        return handles, cm, outs, cap_a, cap_r, cap_c, counts, ready

    def _records_batch_finish(self, handles, cm, outs, cap_a, cap_r, cap_c,
                              counts, ready, find_all):
        """Each handle's overflow is decided once, against the capacities
        its chain ran with (a re-run grows ``cm``'s learned ones); every
        in-capacity handle's records come back in one fetch."""
        with span("finish", handles=len(handles)):
            with wait(self.stats, counts):
                if ready is not None:
                    ready.synchronize()
                counts = counts.reshape(len(outs), 3).tolist()
            self.stats.filter_hits += sum(n for n, _, _ in counts)
            fits = [n <= cap_a and nr <= cap_r and nc <= cap_c
                    for n, nr, nc in counts]
            # one concatenated fetch for every in-capacity handle's records
            pieces = []
            for (rc, rp, *_), ok, (_, nr, _) in zip(outs, fits, counts):
                if ok and nr > 0:
                    pieces += (rc[:nr], rp[:nr])
            rec_flat = self._fetch_after(pieces, ready) if pieces else None
            off = 0
            results = []
            for h, ok, (_, nr, _) in zip(handles, fits, counts):
                if not ok:
                    # overflow: this handle re-runs through the adaptive path
                    with span("retry", stage="batch"):
                        arrays = cm.run_arrays(
                            h.packed, self.config.match_capacity,
                            dev_inputs=h.dev_inputs_for(cm),
                        )
                elif nr == 0:
                    z = np.zeros(0, np.int64)
                    arrays = (z, z, z)
                else:
                    rc_np = rec_flat[off : off + nr]
                    rp_np = rec_flat[off + nr : off + 2 * nr]
                    off += 2 * nr
                    arrays = cm.emit_records_arrays(h.packed, rc_np, rp_np,
                                                    nr)
                results.append(self._arrays_result(
                    h.total_bytes, *arrays, find_all=find_all))
        return results

    def _fetch_after(self, pieces, ready) -> np.ndarray:
        """``torch.cat(pieces)`` on the host.  On CUDA the copy runs on a
        side stream that waits for ``ready`` (the end of the pieces'
        batch) alone, so work enqueued on the current stream after that
        batch (the next batch's chains) does not hold the fetch up."""
        if ready is None:
            flat = torch.cat(pieces)
            with wait(self.stats, flat):
                return flat.numpy()
        if self._fetch_stream is None:
            self._fetch_stream = torch.cuda.Stream(device=self.device)
        side = self._fetch_stream
        with torch.cuda.stream(side):
            side.wait_event(ready)
            for p in pieces:
                p.record_stream(side)
            flat = torch.cat(pieces)
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = side.record_event()
        with wait(self.stats, host):
            done.synchronize()
        return host.numpy()

    # ------------------------------------------------------------ sharded

    def _records_batch_sharded_dispatch(self, handles, cm):
        """Enqueue every shard's records chain of every sharded handle,
        back to back, and stack each handle's ``[gstats_hits, gstats_rec,
        gstats_coarse, n_recs]`` into one device tensor: device work only,
        no host fetch."""
        from .parallel.mesh import process_count
        from .parallel.shard_scan import sharded_sampled_records

        collect = process_count() > 1
        cm.rescale_caps_per_shard(len(handles[0].mesh))
        cap_a = max(cm._cap_hits, 256)
        cap_r = max(cm._cap_flagged, 256)
        outs = []
        with span("dispatch", handles=len(handles)):
            for h in handles:
                chunks, lengths, emit_from, phases = h.dev_inputs_for(cm)
                outs.append(sharded_sampled_records(
                    h.mesh, cm, chunks, lengths, emit_from, cap_a, cap_r,
                    collect=collect, phase_g=phases,
                ))
            stats = torch.stack([
                torch.cat([torch.stack([gh, gr, gc]).reshape(-1), nrs])
                for (_, _, nrs, gh, gr, gc) in outs
            ])
        return handles, cm, outs, cap_a, cap_r, stats, collect

    def _records_batch_sharded_finish(self, handles, cm, outs, cap_a, cap_r,
                                      stats, collect, find_all):
        """One fetch of the stacked stats decides each handle's retries
        (on the per-shard maxima); every in-capacity handle's per-shard
        record slices then come back in one concatenated fetch."""
        with span("finish", handles=len(handles)):
            with wait(self.stats, stats):
                stats = stats.cpu().numpy()
            # column 0: each handle's hits summed over its shards
            self.stats.filter_hits += int(stats[:, 0].sum())
            meta, groups = [], []
            for (rc, rp, *_), st in zip(outs, stats):
                ok = (
                    int(st[1]) <= cap_a
                    and int(st[3]) <= cap_r
                    and int(st[5]) <= cm._cap_coarse
                )
                if ok:
                    groups.append((rc, rp, [int(x) for x in st[6:]]))
                meta.append(ok)
            gathered = iter(self._fetch_shard_records(groups))
            results = []
            for h, ok in zip(handles, meta):
                if not ok:
                    chunks, lengths, emit_from, phases = h.dev_inputs_for(cm)
                    with span("retry", stage="batch"):
                        arrays = self._sharded_records_arrays(
                            h.mesh, cm, h.packed, chunks, lengths,
                            emit_from, collect, phases,
                        )
                else:
                    cells, packs, total = next(gathered)
                    if total == 0:
                        z = np.zeros(0, np.int64)
                        arrays = (z, z, z)
                    else:
                        arrays = cm.emit_records_arrays(
                            h.packed, cells, packs, total
                        )
                results.append(self._arrays_result(
                    h.total_bytes, *arrays, find_all=find_all))
        return results

    def _fetch_shard_records(self, groups):
        """:meth:`_gather_shard_records`, the one point where the host
        waits for the records of ``groups``."""
        n_rec = sum(sum(sizes) for *_, sizes in groups)
        if not n_rec:
            return self._gather_shard_records(groups)
        rc, rp, _ = groups[0]
        rec_bytes = rc.element_size() + rp.element_size()
        with wait(self.stats, n_rec * rec_bytes):
            return self._gather_shard_records(groups)

    @staticmethod
    def _gather_shard_records(groups):
        """ONE concatenated device->host fetch of per-shard record slices
        for any number of record-buffer groups (handles).  ``groups``:
        ``(rc [n_shards, cap], rp [n_shards, cap], sizes [n_shards])``
        each; returns one ``(cells, packs, total)`` numpy triple per
        group, shard-major."""
        pieces = []
        for rc, rp, sizes in groups:
            for s, nr in enumerate(sizes):
                if nr:
                    pieces.append(rc[s, :nr])
                    pieces.append(rp[s, :nr])
        buf = None
        if pieces:
            with span("gather", card=pieces[0].device,
                      shards=len(groups[0][2])):
                flat = torch.cat(pieces)
            buf = flat.cpu().numpy()
        out = []
        off = 0
        z = np.zeros(0, np.int64)
        for rc, rp, sizes in groups:
            total = sum(sizes)
            if total == 0:
                out.append((z, z, 0))
                continue
            cells_l, packs_l = [], []
            for nr in sizes:
                if nr:
                    cells_l.append(buf[off : off + nr])
                    packs_l.append(buf[off + nr : off + 2 * nr])
                    off += 2 * nr
            out.append(
                (np.concatenate(cells_l), np.concatenate(packs_l), total)
            )
        return out

    def _sharded_records_arrays(self, mesh, cm, packed, chunks, lengths,
                                emit_from, collect, phases=None):
        """Adaptive sharded record-verify chain and the shard-major record
        merge: the sharded twin of ``CascadeModel.run_arrays``'s records
        branch.  One fetch of the stats decides retries (the per-shard
        maximum of each stage); the records come back in one fetch."""
        from .parallel.shard_scan import sharded_sampled_records

        state = {}

        def launch_r(cap_a, cap_r):
            rc, rp, nrs, gh, gr, gc = sharded_sampled_records(
                mesh, cm, chunks, lengths, emit_from, cap_a, cap_r,
                collect=collect, phase_g=phases,
            )
            flat = torch.cat([torch.stack([gh, gr, gc]).reshape(-1), nrs])
            with wait(self.stats, flat):
                flat = flat.cpu().numpy()
            self.stats.filter_hits += int(flat[0])
            state["nrs"] = flat[6:]
            return (rc, rp), int(flat[1]), int(flat[3]), int(flat[5])

        (rc, rp), _ = cm.adaptive_chain(launch_r)
        sizes = [int(x) for x in state["nrs"]]
        ((cells, packs, total),) = self._fetch_shard_records(
            [(rc, rp, sizes)]
        )
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z, z
        return cm.emit_records_arrays(packed, cells, packs, total)

    def _run_sharded_cascade(self, dc: DeviceCorpus, capacity: int):
        """The cascade over a sharded handle: ``(docs, ends, pids)``.
        Sampled plans that pass the records gate run the per-shard records
        chain; other plans whose windows verify on the device run the
        sharded flagged-window chain; other sampled plans the sharded flat
        filter with host expansion and verify; the anchored plan the
        sharded candidate filter with host verify."""
        from .parallel.mesh import process_count
        from .parallel.shard_scan import (
            sharded_filter_candidates,
            sharded_filter_hits_sampled,
            sharded_sampled_verified,
        )

        mesh = dc.mesh
        packed = dc.packed
        collect = process_count() > 1
        cm = self.cascade_model
        # capacities learned on one device are global counts; each shard
        # needs only its share
        cm.rescale_caps_per_shard(len(mesh))
        chunks, lengths, emit_from, phases = dc.dev_inputs_for(cm)
        if cm.plan.mode == "sampled" and cm.records_ok:
            return self._sharded_records_arrays(
                mesh, cm, packed, chunks, lengths, emit_from, collect, phases
            )
        if cm.plan.mode == "sampled" and cm.device_verify_ok:
            state = {}

            def launch(cap_a, cap_b):
                cells, nfs, gh, gf, gc = sharded_sampled_verified(
                    mesh, cm, chunks, lengths, cap_a, cap_b,
                    collect=collect, phase_g=phases,
                )
                flat = torch.cat([gh, gf, gc, nfs])
                with wait(self.stats, flat):
                    flat = flat.cpu().numpy()
                self.stats.filter_hits += int(flat[0])
                state["nfs"] = flat[6:]
                return cells, int(flat[1]), int(flat[3]), int(flat[5])

            cells, _ = cm.adaptive_chain(launch)
            pieces = [cells[s, :nf] for s, nf in enumerate(state["nfs"])
                      if nf]
            merged = np.zeros(0, np.int32)
            if pieces:
                flat = torch.cat(pieces)
                with wait(self.stats, flat):
                    merged = flat.cpu().numpy()
            return cm.emit_windows_arrays(packed, merged, merged.shape[0])
        if cm.plan.mode == "sampled":
            while True:
                idx, lw, sw, counts, gstats = sharded_filter_hits_sampled(
                    mesh, cm, chunks, lengths, capacity, collect=collect
                )
                counts_np, n_max = self._shard_counts(counts, gstats)
                self.stats.filter_hits += int(counts_np.sum())
                if n_max <= capacity:
                    break
                capacity = _next_pow2(n_max)
            idx2d, lw2d, sw2d = self._shard_prefixes((idx, lw, sw), n_max)
            parts = []
            total = 0
            for s in range(idx2d.shape[0]):
                st, n = cm.expand_hits(
                    idx2d[s], lw2d[s], sw2d[s], int(counts_np[s]),
                    packed.row_len, packed.lengths,
                )
                parts.append(st)
                total += n
            merged = (
                np.concatenate(parts) if parts else np.zeros(0, np.int64)
            )
            return cm.verify_arrays(packed, merged, total)
        while True:
            idx, counts, gstats = sharded_filter_candidates(
                mesh, cm, chunks, lengths, emit_from, capacity,
                collect=collect,
            )
            counts_np, n_max = self._shard_counts(counts, gstats)
            self.stats.filter_hits += int(counts_np.sum())
            if n_max <= capacity:
                break
            capacity = _next_pow2(n_max)
        (idx2d,) = self._shard_prefixes((idx,), n_max)
        parts = [idx2d[s, : counts_np[s]] for s in range(idx2d.shape[0])]
        merged = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        return cm.verify_arrays(packed, merged, int(counts_np.sum()))

    def _sharded_arrays(self, mesh, engine: str):
        """The engine model's automaton arrays for each shard of ``mesh``,
        held once per distinct device and kept for later passes."""
        from .parallel.mesh import replicated

        key = (engine, tuple(mesh.devices))
        if key not in self._sharded_dev_cache:
            if engine == "kgram":
                model = self.kgram_model
            elif engine == "tile":
                model = self.tile_model
            else:  # "dfa" and "compressed": the matcher's own table
                model = self._model
            self._sharded_dev_cache[key] = replicated(
                mesh, model.device_arrays
            )
        return self._sharded_dev_cache[key]

    def _run_sharded(self, dc: DeviceCorpus, capacity: int, engine: str):
        """Sharded scan of a handle with exact capacity retry: the retry
        decision is one fetch of the worst shard's count; the buffers
        cross to the host once they fit.  Returns the merged ``(idx,
        aux, n)`` (``ops/matches.merge_shard_buffers``)."""
        from .ops.matches import merge_shard_buffers
        from .parallel.mesh import process_count
        from .parallel.shard_scan import (
            sharded_scan_compact,
            sharded_scan_compact_compressed,
            sharded_scan_compact_kgram,
            sharded_scan_compact_tile,
        )

        mesh = dc.mesh
        auto = self._auto
        dev = self._sharded_arrays(mesh, engine)
        collect = process_count() > 1
        rows = (mesh, dev, dc.chunks_d, None, dc.lengths_d, dc.emit_from_d)
        while True:
            if engine == "kgram":
                idx, aux, counts, gstats, _ = sharded_scan_compact_kgram(
                    *rows, n_classes=auto.n_classes, k=self.kgram_model.k,
                    capacity=capacity, collect=collect,
                )
            elif engine == "compressed":
                idx, aux, counts, gstats, _ = sharded_scan_compact_compressed(
                    *rows, n_classes=auto.n_classes, n_dense=auto.n_dense,
                    capacity=capacity, collect=collect,
                )
            elif engine == "tile":
                idx, aux, counts, gstats, _ = sharded_scan_compact_tile(
                    *rows, n_classes=auto.n_classes, capacity=capacity,
                    collect=collect, sync_len=auto.max_len,
                )
            else:
                idx, aux, counts, gstats, _ = sharded_scan_compact(
                    *rows, n_classes=auto.n_classes, capacity=capacity,
                    collect=collect,
                )
            counts_np, n_max = self._shard_counts(counts, gstats)
            if n_max <= capacity:
                break
            capacity = _next_pow2(n_max)
        idx2d, aux2d = self._shard_prefixes((idx, aux), n_max)
        return merge_shard_buffers(idx2d, aux2d, counts_np)

    def _shard_counts(self, counts, gstats):
        """One fetch of a sharded launch's counts: ``(counts [n_shards]
        numpy, the worst shard's count)`` (the retry decision)."""
        head = torch.cat([gstats, counts])
        with wait(self.stats, head):
            head = head.cpu().numpy()
        return head[2:], int(head[1])

    def _shard_prefixes(self, bufs, width: int):
        """The first ``width`` slots of each shard of each ``[n_shards,
        cap]`` buffer, in one fetch: numpy ``[n_shards, width]`` arrays
        (``width`` is the worst shard's count, so every shard's entries
        are there)."""
        n_sh = bufs[0].shape[0]
        flat = torch.cat([b[:, :width].reshape(-1) for b in bufs])
        with wait(self.stats, flat):
            flat = flat.cpu().numpy()
        return tuple(flat.reshape(len(bufs), n_sh, width))

    def _arrays_result(self, n_bytes, docs_a, ends_a, pids_a, find_all) -> dict:
        if not find_all and docs_a.shape[0]:
            # keep only each doc's first end-position group
            _, first_idx = np.unique(docs_a, return_index=True)
            first_pos = np.full(int(docs_a.max()) + 1, -1, dtype=np.int64)
            first_pos[docs_a[first_idx]] = ends_a[first_idx]
            keep = ends_a == first_pos[docs_a]
            docs_a, ends_a, pids_a = (
                docs_a[keep], ends_a[keep], pids_a[keep]
            )
        starts_a = ends_a - self._auto.pat_lens[pids_a]
        self.stats.record(
            "arrays", str(self.device), n_bytes, int(docs_a.shape[0]),
        )
        return {
            "doc": docs_a,
            "pos": ends_a,
            "start_postion": starts_a,  # sic: reference API typo
            "pattern": pids_a,
        }

    def _format(self, pid: int, pos: int) -> dict:
        p = self._patterns[pid]
        rec: dict = {"pos": pos}
        if p.key is not None:
            rec["key"] = p.key
        elif p.ident is not None:
            rec["keyIdx"] = p.ident
        if p.has_aux:
            rec["aux"] = p.aux
        rec["start_postion"] = pos - len(p.value)  # sic: reference API typo
        rec["value"] = p.value_orig
        return rec

    def _emit_records(self, docs_a, ends_a, pids_a, results) -> None:
        """Build reference-schema dicts from emission arrays.  Per-pattern
        constant parts (key/keyIdx/aux items, length, original value) are
        cached so the per-record work is one small dict build."""
        protos = self._fmt_protos()
        for i in range(docs_a.shape[0]):
            tail, plen, value = protos[pids_a[i]]
            pos = int(ends_a[i])
            rec = {"pos": pos}
            rec.update(tail)
            rec["start_postion"] = pos - plen
            rec["value"] = value
            results[docs_a[i]].append(rec)

    def _fmt_protos(self):
        if getattr(self, "_protos", None) is None or len(self._protos) != len(
            self._patterns
        ):
            protos = []
            for p in self._patterns:
                tail = {}
                if p.key is not None:
                    tail["key"] = p.key
                elif p.ident is not None:
                    tail["keyIdx"] = p.ident
                if p.has_aux:
                    tail["aux"] = p.aux
                protos.append((tail, len(p.value), p.value_orig))
            self._protos = protos
        return self._protos

    # ------------------------------------------------------------ streaming

    def stream(self):
        """Open a :class:`~php_aho_corasick_tpu_torch.stream.StreamScanner`
        — the ``keep=1`` chunk-continuation mode
        (``ahocorasick.c:191-194``): matches spanning feed boundaries ARE
        found, positions are global stream offsets."""
        from .stream import StreamScanner

        if not self._valid:
            warn("stream on a closed matcher")
            raise StateError("matcher is closed")
        return StreamScanner(self)

    # ------------------------------------------------------------ replace

    def replace(self, text, replacements, mode: str = "normal"):
        """One-shot search-and-replace (NORMAL/LAZY nominee semantics of
        the reference's MultiFast replace engine; see replace.py)."""
        from . import replace as _replace

        if not self._valid:
            warn("replace on a closed matcher")
            raise StateError("matcher is closed")
        return _replace.replace(self, text, replacements, mode)

    def replace_stream(self, replacements, mode: str = "normal"):
        """Streaming replace over chunked input; returns a
        :class:`~php_aho_corasick_tpu_torch.replace.ReplaceStream`."""
        from .replace import ReplaceStream

        if not self._valid:
            warn("replace_stream on a closed matcher")
            raise StateError("matcher is closed")
        return ReplaceStream(self, replacements, mode)

    def warmup(self, doc_bytes: int = 0, n_docs: int = 1) -> None:
        """One device scan of ``n_docs`` documents of ``doc_bytes`` bytes
        (default ``chunk_len``), so the hand kernels are built and the
        device holds buffers of that shape before serving starts."""
        if doc_bytes <= 0:
            doc_bytes = self.config.chunk_len
        dummy = [b"\xff" * doc_bytes] * n_docs
        self.match_many(dummy, backend="device")

    def iter_matches(
        self,
        haystack: Haystack,
        find_all: bool = True,
        segment_bytes: int = 1 << 20,
    ) -> Iterator[dict]:
        """Pull-style match iterator — the reference's
        ``ac_trie_settext``/``ac_trie_findnext`` mode
        (``src/multifast/ahocorasick.c:253-281``, unused by its own PHP
        layer).  Incremental: the haystack is consumed one
        ``segment_bytes`` slice at a time through the streaming DFA-state
        carry (:meth:`stream`), so segment ``k+1`` is never scanned until
        the consumer exhausts segment ``k``'s matches.  Record schema and
        order match :meth:`match`.

        With ``find_all=False``, yields only the first end-position's
        match group, then stops scanning (the callback-return abort,
        ``php_ahocorasick.c:588``)."""
        # validity check at CALL time (not first iteration): match() and
        # stream() raise immediately on a closed matcher, so this must
        # too, hence the non-generator wrapper returning an inner generator
        if not self._valid:
            warn("match on a closed matcher")
            raise StateError("matcher is closed")
        data = _as_bytes(haystack)
        seg = max(1, int(segment_bytes))

        def gen() -> Iterator[dict]:
            with self.stream() as st:
                for off in range(0, len(data), seg):
                    recs = st.feed(data[off : off + seg])
                    if not find_all and recs:
                        first_pos = recs[0]["pos"]
                        for r in recs:
                            if r["pos"] == first_pos:
                                yield r
                        return
                    yield from recs

        return gen()

    # ------------------------------------------------------------ teardown

    def close(self) -> bool:
        """Invalidate the matcher (finalizes first; a second call returns
        False)."""
        if not self._valid:
            return False
        if not self._finalized:
            self.finalize()
        self._valid = False
        return True

    def __enter__(self) -> "Matcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
