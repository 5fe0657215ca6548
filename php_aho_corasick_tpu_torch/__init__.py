"""php_aho_corasick_tpu_torch — the PyTorch/CUDA port of php_aho_corasick_tpu.

Aho-Corasick multi-pattern matching with byte-exact positions: the
reference's match records (``Matcher.match``, the six PHP-parity
``ahocorasick_*`` functions) and its columnar output, served from a
device-resident corpus.  Large scans run the sampled gram-filter cascade
(a fused filter kernel written for Hopper, ``csrc/fused_sampled_extract.cu``,
slot compaction and an exact DFA window walk on the device); small
automata run the tile DFA kernel (``csrc/scan_states_tile.cu``); the rest
runs the dense DFA walk.  Match records are expanded on the host.
Chunked input goes through ``Matcher.stream`` (matches across feed
boundaries), ``Matcher.iter_matches`` and ``Matcher.replace_stream``.
Automata build with the C++ builder (``native/``, g++ at first use) and
save and load in the JAX package's format (``utils/serialization.py``);
``python -m php_aho_corasick_tpu_torch`` is the command line.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .api import DeviceCorpus, Matcher, StateError
from .compat import (
    ahocorasick_add_patterns,
    ahocorasick_deinit,
    ahocorasick_finalize,
    ahocorasick_init,
    ahocorasick_isValid,
    ahocorasick_match,
)
from .config import DEFAULT_CONFIG, ScanConfig
from .core.tables import CompiledAutomaton
from .errors import AddStatus, AhoError, AhoException, AhoWarning
from .patterns import Pattern, PatternFormatError

__version__ = "0.1.0"

__all__ = [
    "Matcher",
    "DeviceCorpus",
    "ScanConfig",
    "DEFAULT_CONFIG",
    "CompiledAutomaton",
    "Pattern",
    "PatternFormatError",
    "StateError",
    "AddStatus",
    "AhoError",
    "AhoException",
    "AhoWarning",
    "ahocorasick_init",
    "ahocorasick_add_patterns",
    "ahocorasick_finalize",
    "ahocorasick_match",
    "ahocorasick_isValid",
    "ahocorasick_deinit",
    "__version__",
]
