"""Pattern spec parsing and validation.

Reproduces the observable validation surface of the reference's
``php_ahocorasick_process_pattern`` (``src/php_ahocorasick.c:195-336``):

* accepted spec keys, matched case-insensitively: ``key``, ``id``,
  ``value``, ``aux``, ``ignoreCase`` (``php_ahocorasick.c:242-249``);
* an unknown key, a missing ``value``, or ``key`` and ``id`` together are
  *structural* failures: warning + batch rejection (not an exception in the
  reference) — here :class:`PatternFormatError` after emitting
  :class:`AhoWarning`;
* a non-int ``id`` or non-string ``key``/``value`` is a *type* error and
  throws ``AhoException`` (``php_ahocorasick.c:253-333``) — here
  :class:`AhoError`;
* ``ignoreCase`` is deprecated, warned about and ignored
  (``php_ahocorasick.c:271-274, 316-318``);
* a bare (non-dict) string entry counts as ``value``
  (``php_ahocorasick.c:230-231``, numeric-keyed zval);
* ``aux`` is kept by reference, not copied (``php_ahocorasick.c:265-269``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Union

from .errors import AhoError, warn

_ALLOWED_KEYS = {"key", "id", "value", "aux", "ignorecase"}
_MISSING = object()


class PatternFormatError(AhoError):
    """Structural pattern-spec failure (reference: warning + ``false``).

    Subclasses :class:`AhoError` for Pythonic callers; the PHP-compat layer
    catches exactly this type and converts it to the reference's
    warn-and-return-``false`` behavior.
    """


@dataclasses.dataclass
class Pattern:
    """One validated pattern with its metadata."""

    value: bytes  # search text (byte-exact, case-sensitive)
    value_orig: Union[str, bytes]  # as given; echoed in match records
    key: Optional[str] = None  # string id  -> "key" in match records
    ident: Optional[int] = None  # numeric id -> "keyIdx" in match records
    aux: Any = None
    has_aux: bool = False

    def __len__(self) -> int:
        return len(self.value)


def _as_bytes(v: Union[str, bytes]) -> bytes:
    return v.encode("utf-8") if isinstance(v, str) else bytes(v)


def parse_pattern_spec(spec: Any) -> Pattern:
    """Validate one pattern spec (dict, or bare str/bytes meaning value)."""
    if type(spec) is dict:
        # fast paths for the exact common shapes (signature-scale
        # builds feed millions of these; the general key loop below
        # costs ~5 us/spec — round-5 build profile).  Checks are
        # type-exact so every deviation falls through to the full
        # reference-parity validation with identical behavior
        # (type(True) is not int, so bool ids still reject there).
        n = len(spec)
        if n == 2 and "id" in spec and "value" in spec:
            ident, value = spec["id"], spec["value"]
            if type(ident) is int and type(value) in (bytes, str):
                return Pattern(
                    value=_as_bytes(value), value_orig=value, ident=ident
                )
        elif n == 1 and "value" in spec:
            value = spec["value"]
            if type(value) in (bytes, str):
                return Pattern(value=_as_bytes(value), value_orig=value)
        elif n == 2 and "key" in spec and "value" in spec:
            key, value = spec["key"], spec["value"]
            if type(key) is str and type(value) in (bytes, str):
                return Pattern(
                    value=_as_bytes(value), value_orig=value, key=key
                )
    if isinstance(spec, (str, bytes, bytearray)):
        v = spec if not isinstance(spec, bytearray) else bytes(spec)
        return Pattern(value=_as_bytes(v), value_orig=v)
    if not isinstance(spec, dict):
        warn(f"Unsupported pattern spec type: {type(spec).__name__}")
        raise PatternFormatError("invalid pattern spec")

    key = _MISSING
    ident = _MISSING
    value = _MISSING
    aux = _MISSING
    for k, v in spec.items():
        if isinstance(k, int):
            # analog of a numeric-keyed zval entry: counts as `value`
            # (php_ahocorasick.c:230-231)
            value = v
            continue
        lk = str(k).lower()
        if lk not in _ALLOWED_KEYS:
            warn(f"Unknown pattern field: {k!r}")
            raise PatternFormatError(f"unknown pattern field {k!r}")
        if lk == "key":
            key = v
        elif lk == "id":
            ident = v
        elif lk == "value":
            value = v
        elif lk == "aux":
            aux = v
        elif lk == "ignorecase":
            warn("ignoreCase is deprecated and has no effect; the engine is case-sensitive")

    if ident is not _MISSING and (isinstance(ident, bool) or not isinstance(ident, int)):
        raise AhoError("Pattern id must be an integer")
    if key is not _MISSING and not isinstance(key, str):
        raise AhoError("Pattern key must be a string")
    if value is _MISSING:
        warn("Pattern is missing the mandatory 'value' field")
        raise PatternFormatError("missing value")
    if not isinstance(value, (str, bytes, bytearray)):
        raise AhoError("Pattern value must be a string")
    if key is not _MISSING and ident is not _MISSING:
        warn("Pattern fields 'key' and 'id' are mutually exclusive")
        raise PatternFormatError("key and id are mutually exclusive")

    v_orig = value if not isinstance(value, bytearray) else bytes(value)
    return Pattern(
        value=_as_bytes(v_orig),
        value_orig=v_orig,
        key=None if key is _MISSING else key,
        ident=None if ident is _MISSING else ident,
        aux=None if aux is _MISSING else aux,
        has_aux=aux is not _MISSING,
    )


def parse_batch(specs: Sequence[Any]) -> List[Pattern]:
    """Validate a whole batch before any insertion (the reference builds the
    full pattern list first and only then feeds the trie — a failed batch is
    atomic, ``php_ahocorasick.c:389-489``)."""
    return [parse_pattern_spec(s) for s in specs]
