"""Matcher files across the two packages: a matcher that the port or the
JAX package saved loads in the port (on the CPU here) and in the JAX
package, dense and compressed, with and without ``aux``, and a
hand-written format-v1 file loads; every loaded matcher's records equal
the JAX ``Matcher``'s on the same haystack."""

import base64
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import php_aho_corasick_tpu as ref  # noqa: E402
from php_aho_corasick_tpu.utils import serialization as ref_ser  # noqa: E402

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch.models.compressed_dfa import (  # noqa: E402
    CompressedDfaModel,
)
from php_aho_corasick_tpu_torch.models.dense_dfa import (  # noqa: E402
    DenseDfaModel,
)
from php_aho_corasick_tpu_torch.utils import serialization  # noqa: E402

_SPECS = [
    {"key": "ab", "value": "alfa", "aux": {"n": 1}},
    {"key": "ac", "value": "beta"},
    {"key": "ad", "value": "gamma", "aux": [1, 2]},
    {"id": 7, "value": b"zeta"},
    {"value": "lfa"},
    {"value": "été"},  # UTF-8: two-byte code points
]
_HAY = "alFABETA gamma zetaomegaalfa! été beta" * 30


def _matcher(pkg, table_format):
    cfg = pkg.ScanConfig(table_format=table_format, auto_shard=False)
    if pkg is port:
        m = port.Matcher(_SPECS, cfg, device="cpu")
    else:
        m = ref.Matcher(_SPECS, cfg)
    m.finalize()
    return m


def _records(m, with_aux=True):
    """Records of ``match`` and ``match_many``; without ``with_aux`` each
    aux value is ``None`` (a file saved without aux loads so)."""
    recs = [m.match(_HAY)] + m.match_many([_HAY, "", "alfa"],
                                          backend="device")
    if not with_aux:
        for r in (r for rs in recs for r in rs if "aux" in r):
            r["aux"] = None
    return recs


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("table_format", ["dense", "compressed"])
@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_round_trip_across_packages(tmp_path, writer, reader, table_format,
                                    with_aux):
    pkgs = {"port": (port, serialization), "jax": (ref, ref_ser)}
    wpkg, wser = pkgs[writer]
    path = tmp_path / "m.npz"
    wser.save_matcher(_matcher(wpkg, table_format), path, with_aux=with_aux)
    if reader == "port":
        m = serialization.load_matcher(path, device="cpu")
        assert m.device.type == "cpu"
        model_cls = (CompressedDfaModel if table_format == "compressed"
                     else DenseDfaModel)
        assert type(m.model) is model_cls
    else:
        m = ref_ser.load_matcher(path)
    assert m.finalized and m.table_format == table_format
    want = _matcher(ref, table_format)
    assert m.describe() == want.describe()
    assert _records(m) == _records(want, with_aux)
    got = m.match_arrays([_HAY, _HAY[::-1]])
    exp = want.match_arrays([_HAY, _HAY[::-1]])
    for key in ("doc", "pos", "start_postion", "pattern"):
        np.testing.assert_array_equal(got[key], exp[key])


def test_loaded_matcher_is_closed_for_adds(tmp_path):
    path = tmp_path / "m.npz"
    serialization.save_matcher(_matcher(port, "dense"), path)
    m = serialization.load_matcher(path, device="cpu")
    assert not m.finalize()  # already finalized
    with pytest.raises(port.StateError), pytest.warns(port.AhoWarning):
        m.add_patterns(["x"])


def test_format_v1_file_loads(tmp_path):
    """A version-1 file (no ``table_format``: dense) written by hand."""
    mj = _matcher(ref, "dense")
    auto = mj.automaton
    meta = {
        "format_version": 1,
        "patterns": [
            {"value": base64.b64encode(p.value).decode("ascii"),
             "value_is_str": isinstance(p.value_orig, str), "key": p.key,
             "ident": p.ident, "has_aux": p.has_aux}
            for p in mj._patterns
        ],
        "max_pattern_length": 1024,
    }
    path = tmp_path / "v1.npz"
    np.savez_compressed(
        path, table=auto.table, byte_class=auto.byte_class,
        emit_start=auto.emit_start, emit_pats=auto.emit_pats,
        pat_lens=auto.pat_lens, state_depth=auto.state_depth,
        final_start=np.int64(auto.final_start),
        max_len=np.int64(auto.max_len),
        meta_json=np.frombuffer(json.dumps(meta).encode(), np.uint8),
    )
    m = serialization.load_matcher(path, device="cpu")
    assert m.table_format == "dense"
    assert _records(m) == _records(mj, with_aux=False)
    meta["format_version"] = 3
    np.savez_compressed(
        path, table=auto.table,
        meta_json=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    with pytest.raises(ValueError, match="version"):
        serialization.load_matcher(path, device="cpu")
