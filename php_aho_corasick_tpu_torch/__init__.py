"""php_aho_corasick_tpu_torch — the PyTorch/CUDA port of php_aho_corasick_tpu.

Aho-Corasick multi-pattern matching with byte-exact positions and the
reference's columnar output, served from a device-resident corpus through
the sampled gram-filter cascade: a fused filter kernel written for Hopper
(``csrc/fused_sampled_extract.cu``), slot compaction and an exact DFA
window walk on the device, and host expansion of the match records.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .api import DeviceCorpus, Matcher, StateError
from .config import DEFAULT_CONFIG, ScanConfig
from .errors import AddStatus, AhoError

__version__ = "0.1.0"

__all__ = [
    "Matcher",
    "DeviceCorpus",
    "ScanConfig",
    "DEFAULT_CONFIG",
    "StateError",
    "AddStatus",
    "AhoError",
    "__version__",
]
