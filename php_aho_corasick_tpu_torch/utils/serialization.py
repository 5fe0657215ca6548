"""Matcher persistence.

The reference never serializes automata — they are rebuilt from patterns in
every process (cheap at its scale; ``README.md:183`` counts construction
inside 0.17 s).  At million-pattern signature scale builds are expensive
(~20 s native compile, round-5 build profile), so the compiled tables +
pattern metadata are worth saving — in BOTH table layouts: the dense
``[S, C]`` table and the compressed dense-bank + single-exception format
that signature-scale sets actually compile to (format v2; v1 files load
unchanged).  The format is the JAX package's: a file either package
wrote loads in the other.

Format: one ``.npz`` holding the automaton arrays plus a JSON-encoded
metadata blob (pattern values as base64, keys/ids, value types).  ``aux``
objects are arbitrary Python values and are only saved when
``with_aux=True`` (pickled — load only trusted files).
"""

from __future__ import annotations

import base64
import json
import pickle
from typing import Optional

import numpy as np

from ..api import Matcher
from ..config import ScanConfig
from ..core.tables import CompiledAutomaton, CompressedAutomaton
from ..patterns import Pattern

FORMAT_VERSION = 2


def save_matcher(matcher: Matcher, path, with_aux: bool = False) -> None:
    """Save a finalized matcher's compiled automaton + pattern metadata
    (both table formats — reference analog: none; SURVEY §5 checkpoint)."""
    matcher.finalize()
    auto = matcher.automaton
    compressed = isinstance(auto, CompressedAutomaton)
    meta = {
        "format_version": FORMAT_VERSION,
        "table_format": "compressed" if compressed else "dense",
        "patterns": [
            {
                "value": base64.b64encode(p.value).decode("ascii"),
                "value_is_str": isinstance(p.value_orig, str),
                "key": p.key,
                "ident": p.ident,
                "has_aux": p.has_aux,
            }
            for p in matcher._patterns
        ],
        "max_pattern_length": matcher.config.max_pattern_length,
    }
    payload = {
        "byte_class": auto.byte_class,
        "emit_start": auto.emit_start,
        "emit_pats": auto.emit_pats,
        "pat_lens": auto.pat_lens,
        "state_depth": auto.state_depth,
        "final_start": np.int64(auto.final_start),
        "max_len": np.int64(auto.max_len),
        "meta_json": np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8
        ),
    }
    if compressed:
        payload["dense_table"] = auto.dense_table
        payload["comp_meta"] = auto.meta
        payload["exc_target"] = auto.exc_target
        payload["dense_final_start"] = np.int64(auto.dense_final_start)
    else:
        payload["table"] = auto.table
    if with_aux:
        payload["aux_pickle"] = np.frombuffer(
            pickle.dumps([p.aux for p in matcher._patterns]), dtype=np.uint8
        )
    np.savez_compressed(path, **payload)


def load_matcher(
    path, config: Optional[ScanConfig] = None, device=None
) -> Matcher:
    """Load a matcher saved by :func:`save_matcher` (already finalized),
    its tables on ``device`` (CUDA unless the caller asks for the CPU)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
        if meta["format_version"] not in (1, FORMAT_VERSION):
            raise ValueError("unsupported matcher file version")
        fmt = meta.get("table_format", "dense")
        if fmt == "compressed":
            auto = CompressedAutomaton(
                dense_table=z["dense_table"],
                meta=z["comp_meta"],
                exc_target=z["exc_target"],
                byte_class=z["byte_class"],
                emit_start=z["emit_start"],
                emit_pats=z["emit_pats"],
                pat_lens=z["pat_lens"],
                state_depth=z["state_depth"],
                dense_final_start=int(z["dense_final_start"]),
                final_start=int(z["final_start"]),
                max_len=int(z["max_len"]),
            )
        else:
            auto = CompiledAutomaton(
                table=z["table"],
                byte_class=z["byte_class"],
                emit_start=z["emit_start"],
                emit_pats=z["emit_pats"],
                pat_lens=z["pat_lens"],
                state_depth=z["state_depth"],
                final_start=int(z["final_start"]),
                max_len=int(z["max_len"]),
            )
        auxes = (
            pickle.loads(bytes(z["aux_pickle"]))
            if "aux_pickle" in z
            else [None] * len(meta["patterns"])
        )
    auto.validate()

    cfg = config or ScanConfig(
        max_pattern_length=meta["max_pattern_length"]
    )
    m = Matcher(config=cfg, device=device)
    for spec, aux in zip(meta["patterns"], auxes):
        value = base64.b64decode(spec["value"])
        m._patterns.append(
            Pattern(
                value=value,
                value_orig=value.decode("utf-8") if spec["value_is_str"] else value,
                key=spec["key"],
                ident=spec["ident"],
                aux=aux,
                has_aux=spec["has_aux"],
            )
        )
    m._auto = auto
    if fmt == "compressed":
        from ..models.compressed_dfa import CompressedDfaModel

        m._model = CompressedDfaModel(auto, cfg, m.device)
    else:
        from ..models.dense_dfa import DenseDfaModel

        m._model = DenseDfaModel(auto, cfg, m.device)
    m._trie.closed = True
    m._finalized = True
    return m
