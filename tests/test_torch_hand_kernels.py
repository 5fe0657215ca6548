"""The hand kernels' seam (``ops/_build``): one declared entry for every
``csrc/<name>.cu``, whose public wrapper on CPU tensors is its plain
version on the same arguments, counts no launch and hands nothing to an
observer.  A new kernel is picked up here by its entry: it needs only its
small inputs in ``INPUTS``."""

import inspect
import sys

import pytest

torch = pytest.importorskip("torch")

from php_aho_corasick_tpu_torch.ops import _build  # noqa: E402
from php_aho_corasick_tpu_torch.ops.scan_torch import (  # noqa: E402
    blocked_nonzero,
)

SALTS = (0x9E3779B9, 0x7F4A7C15)
INT32_MAX = 2**31 - 1


def _ints(g, *shape, lo=-(2**31), hi=2**31):
    return torch.randint(lo, hi, shape, generator=g,
                         dtype=torch.int64).to(torch.int32)


def _sparse(g, x, p):
    return torch.where(torch.rand(x.shape, generator=g) < p, x, 0)


def _bytes(g, *shape, alphabet=b"abc"):
    pool = torch.tensor(list(alphabet), dtype=torch.uint8)
    return pool[torch.randint(0, len(alphabet), shape, generator=g)]


def _one(v):
    return torch.tensor(v, dtype=torch.int32)


def _fused(g):
    spc, block_r = 2, 8
    R_pad = 2 * block_r
    return ((_ints(g, 2 * (1 << 12) // 128, 128),
             _ints(g, spc, R_pad + 8, 128), None,
             torch.ones((1, 1), dtype=torch.int32)),
            dict(salts=SALTS, log2_rows=12, pack=1, q=9, spc=spc, mpr=8,
                 block_r=block_r, n_grid=R_pad * 128 - 5))


def _grouped(g):
    words = _sparse(g, _ints(g, 1 << 8), 0.3)
    return ((words, _ints(g, 2, 16 * 2), None, _one(1)),
            dict(q=5, spc=2, log2_words=8, salts=SALTS, mpr=8, block_r=4))


def _refine(g):
    args, kw = _grouped(g)
    r_s, w_s, swo_s, _, _ = _build.KERNELS["grouped_take_extract"].plain(
        *args, **kw)
    slot, _ = blocked_nonzero(
        ((r_s >= 0) & ((w_s | swo_s) != 0)).reshape(-1), 64)
    return ((slot, r_s, w_s, swo_s, args[1]),
            dict(mpr=kw["mpr"], block_r=kw["block_r"], spc=kw["spc"]))


def _verify(g):
    S, C, B, L, stride, H = 6, 3, 2, 64, 4, 10
    byte_class = torch.zeros(256, dtype=torch.int32)
    byte_class[97], byte_class[98] = 1, 2
    M = -(-L // stride)
    grid_idx = torch.full((H + 2,), INT32_MAX, dtype=torch.int32)
    grid_idx[:H] = torch.randperm(B * M, generator=g)[:H].to(torch.int32)
    return ((torch.randint(0, S, (S * C,), generator=g).to(torch.int16),
             byte_class, torch.tensor([97, 98], dtype=torch.uint8),
             _bytes(g, B, L), _one([L, 50]), _one([0, 3]), grid_idx,
             _one(4)),
            dict(n_classes=C, stride=stride, win_len=8, capacity=64,
                 n_hits=H))


def _tile(g):
    S, C, B, L = 5, 3, 3, 40
    byte_class = torch.zeros(256, dtype=torch.int32)
    byte_class[97], byte_class[98] = 1, 2
    return ((torch.randint(0, S, (S * C,), generator=g).to(torch.int32),
             byte_class, torch.tensor([97, 98], dtype=torch.uint8),
             _bytes(g, B, L), torch.randint(0, S, (B,), generator=g)
             .to(torch.int32), C),
            dict(lengths=_one([L, 0, 17])))


#: each kernel's small CPU inputs, ``(args, kwargs)`` from a generator
INPUTS = {
    "fused_sampled_extract": _fused,
    "bloom_word_vmem": lambda g: (
        (_ints(g, 2 * (1 << 12) // 128, 128), _ints(g, 100), SALTS, 12), {}),
    "bloom_hit": lambda g: (
        (_ints(g, 32), torch.randint(0, 1024, (50,), generator=g)
         .to(torch.int32)), {}),
    "grouped_take_extract": _grouped,
    "grouped_take_refine": _refine,
    "flat_take_extract": lambda g: (
        (_sparse(g, _ints(g, 1 << 8), 0.3), _bytes(g, 2, 64), None,
         _one(1)),
        dict(q=4, stride=3, log2_words=8, salts=SALTS[:1], capacity=64)),
    "verify_records": _verify,
    "scan_states_tile": _tile,
}
STEMS = {p.stem for p in _build.CSRC.glob("*.cu")}


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", sorted(STEMS | set(_build.KERNELS)))
def test_hand_kernel_entry_runs_its_plain_version_on_cpu(name):
    assert name in _build.KERNELS, f"csrc/{name}.cu has no declared entry"
    assert name in STEMS, f"entry {name} has no csrc/{name}.cu"
    kernel = _build.KERNELS[name]
    assert getattr(sys.modules[kernel.__module__], name) is kernel
    assert _params(kernel) == _params(kernel.plain)
    args, kw = INPUTS[name](torch.Generator().manual_seed(len(name)))
    before = kernel.launches, kernel.segmented_launches
    seen = []
    with _build.observed(lambda *call: seen.append(call)):
        got = kernel(*args, **kw)
    want = kernel.plain(*args, **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert any(a.numel() and a.any() for a in got), "an empty case"
    assert (kernel.launches, kernel.segmented_launches) == before
    assert seen == []
