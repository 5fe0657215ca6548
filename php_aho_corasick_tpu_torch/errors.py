"""Error types and status codes.

Mirrors the observable error surface of the reference extension:
  - ``AC_STATUS_t`` (reference ``src/multifast/actypes.h:118-125``) becomes
    :class:`AddStatus`.
  - The PHP ``AhoException`` class (reference ``src/php_ahocorasick.c:601-605``)
    becomes :class:`AhoError` (alias ``AhoException``).
  - PHP warnings (``php_error_docref`` calls throughout the glue) become
    :class:`AhoWarning` emitted via :mod:`warnings`.
"""

from __future__ import annotations

import enum
import warnings


class AhoError(Exception):
    """Raised for type errors in pattern specs.

    The reference throws ``AhoException`` when ``id`` is not an integer or
    ``key``/``value`` are not strings (``src/php_ahocorasick.c:253-333``).
    """


#: PHP-parity alias for :class:`AhoError`.
AhoException = AhoError


class AhoWarning(UserWarning):
    """Non-fatal problems the reference reports via PHP warnings."""


class AddStatus(enum.IntEnum):
    """Per-pattern insertion status (reference ``actypes.h:118-125``).

    The reference PHP glue ignores these (unchecked call at
    ``src/php_ahocorasick.c:484``), silently dropping duplicate/overlong
    patterns from the automaton.  This framework keeps match-output parity
    with that behavior but *surfaces* the statuses from
    :meth:`Matcher.add_patterns`.
    """

    SUCCESS = 0
    DUPLICATE_PATTERN = 1
    LONG_PATTERN = 2
    ZERO_PATTERN = 3
    TRIE_CLOSED = 4


def warn(message: str) -> None:
    """Emit an :class:`AhoWarning` (analog of ``php_error_docref`` warnings)."""
    warnings.warn(message, AhoWarning, stacklevel=3)
