"""PHP-parity procedural API — drop-in analogs of the reference's 6
userland functions (``src/php_ahocorasick.stub.php:12-37``).

Failure convention matches the reference: structural/lifecycle problems emit
an :class:`AhoWarning` and return ``False`` (the PHP warn-and-false idiom);
*type* errors in pattern specs raise :class:`AhoException`
(``php_ahocorasick.c:253-333``).
"""

from __future__ import annotations

from typing import Any, List, Sequence, Union

from .api import Matcher, StateError
from .errors import warn
from .patterns import PatternFormatError

__all__ = [
    "ahocorasick_init",
    "ahocorasick_add_patterns",
    "ahocorasick_finalize",
    "ahocorasick_match",
    "ahocorasick_isValid",
    "ahocorasick_deinit",
]


def ahocorasick_init(
    patterns: Sequence[Any], *, device=None
) -> Union[Matcher, bool]:
    """Build a matcher from a pattern list; ``False`` on structural failure
    (any bad pattern rolls back the whole init,
    ``php_ahocorasick.c:819-824``).  ``device`` is the matcher's device
    (CUDA unless given)."""
    try:
        return Matcher(patterns, device=device)
    except PatternFormatError:
        return False


def _valid_matcher(m: Any) -> bool:
    return isinstance(m, Matcher) and m.is_valid()


def ahocorasick_add_patterns(m: Any, patterns: Sequence[Any]) -> bool:
    """Add a batch to a non-finalized matcher
    (``php_ahocorasick.c:882-925``)."""
    if not _valid_matcher(m):
        warn("Invalid AhoCorasick matcher")
        return False
    try:
        m.add_patterns(patterns)
        return True
    except (PatternFormatError, StateError):
        return False


def ahocorasick_finalize(m: Any) -> bool:
    """Finalize; ``True`` only on the open->finalized transition
    (``php_ahocorasick.c:845-875``)."""
    if not _valid_matcher(m):
        warn("Invalid AhoCorasick matcher")
        return False
    return m.finalize()


def ahocorasick_match(
    haystack: Union[str, bytes], m: Any, find_all: bool = True
) -> Union[List[dict], bool]:
    """Scan; returns the reference-schema match record list
    (``php_ahocorasick.c:664-746``)."""
    if not _valid_matcher(m):
        warn("Invalid AhoCorasick matcher")
        return False
    return m.match(haystack, find_all=find_all)


def ahocorasick_isValid(m: Any) -> bool:
    return _valid_matcher(m)


def ahocorasick_deinit(m: Any) -> bool:
    if not isinstance(m, Matcher):
        warn("Invalid AhoCorasick matcher")
        return False
    return m.close()
