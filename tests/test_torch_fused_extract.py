"""The port's fused sampled filter against the JAX package's.

Same numpy inputs through ``php_aho_corasick_tpu.ops.filter_pallas.
fused_sampled_extract`` (interpret mode: its XLA mirror) and through the
port's ``fused_sampled_extract`` on CPU tensors (its plain PyTorch
version): all five outputs must be equal bit for bit.  The CUDA kernel is
held against the plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from php_aho_corasick_tpu.ops.filter_pallas import (  # noqa: E402
    fused_sampled_extract as jax_extract,
)
from php_aho_corasick_tpu_torch.ops.filter_cuda import (  # noqa: E402
    fused_sampled_extract,
)

BLOCK_R = 1024
PREFIX_SALTS = (0x7F4A7C15, 0x94D049BB)


@pytest.fixture(autouse=True)
def _jax_eager():
    """Run the JAX side op by op: at these sizes XLA's compile of its
    unrolled mirror costs far more than the work, and the results are
    the same."""
    with jax.disable_jit():
        yield


def _inputs(seed, k, log2_rows, pack, spc, has_shorts, pb_rows, n_blocks=2):
    rng = np.random.default_rng(seed)
    n_banks = (1 << log2_rows) // 128
    # sparse-ish bank words so the AND over k salts leaves a mix of hits
    # and misses (dense random words would hit every cell)
    dens = 0.5 ** (1.0 / k) if k > 3 else 0.97
    bits = rng.random((k * n_banks // pack, 128, 32)) < dens
    table = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    table = table.astype(np.uint64).astype(np.uint32).view(np.int32)
    R_pad = n_blocks * BLOCK_R
    phases = rng.integers(
        -(2**31), 2**31, (spc, R_pad + 8, 128), dtype=np.int64
    ).astype(np.int32)
    sw = None
    if has_shorts:
        sw = (
            rng.integers(0, 2**31, (R_pad, 128)).astype(np.int32)
            * (rng.random((R_pad, 128)) < 0.01)
        ).astype(np.int32)
    ptab = None
    if pb_rows:
        ptab = rng.integers(-(2**31), 2**31, (pb_rows, 128),
                            dtype=np.int64).astype(np.int32)
    return table, phases, sw, ptab, R_pad * 128 - 555


def _run_both(table, phases, sw, ptab, n_grid, **kw):
    pb_log2 = (ptab.size * 32).bit_length() - 1 if ptab is not None else 0
    psalts = PREFIX_SALTS if ptab is not None else ()
    got_j = jax_extract(
        jnp.asarray(table), tuple(jnp.asarray(p) for p in phases),
        None if sw is None else jnp.asarray(sw), jnp.ones((1, 1), jnp.int32),
        block_r=BLOCK_R, n_grid=n_grid, interpret=True,
        prefix_table=None if ptab is None else jnp.asarray(ptab),
        prefix_salts=psalts, prefix_log2=pb_log2, **kw,
    )
    t = torch.from_numpy
    got_t = fused_sampled_extract(
        t(table), t(phases), None if sw is None else t(sw),
        torch.ones((1, 1), dtype=torch.int32),
        block_r=BLOCK_R, n_grid=n_grid,
        prefix_table=None if ptab is None else t(ptab),
        prefix_salts=psalts, prefix_log2=pb_log2, **kw,
    )
    return [np.asarray(x) for x in got_j], [x.numpy() for x in got_t]


@pytest.mark.parametrize(
    "pack,has_shorts,prefix_on",
    [(1, False, False), (4, True, False), (4, False, True)],
)
def test_fused_extract_matches_jax(pack, has_shorts, prefix_on):
    spc, k, log2_rows = 2, 3, 10
    table, phases, sw, _, n_grid = _inputs(
        11 + pack, k, log2_rows, pack, spc, has_shorts, 0
    )
    salts = tuple((0x9E3779B9 * (2 * i + 1)) & 0xFFFFFFFF for i in range(k))
    got_j, got_t = _run_both(
        table, phases, sw, None, n_grid, salts=salts, log2_rows=log2_rows,
        pack=pack, q=9, spc=spc, mpr=16, l16=16 if prefix_on else 0,
        prefix_on=prefix_on,
    )
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(a, b)
    r_s, cnt = got_t[0], got_t[4]
    assert int(cnt.sum()) > 0
    assert int((r_s >= 0).sum()) == int(np.minimum(cnt, 16).sum())


@pytest.mark.parametrize("mpr", [24, 128])
def test_fused_extract_headline_config(mpr):
    """The headline plan's shapes: k=8 salts, 4096-word tables packed 4
    banks per word, q=9 at stride 8, a 12-byte prefix hash, and the
    in-kernel refinement against an 8-row prefix bloom."""
    spc, k, log2_rows, pack = 2, 8, 12, 4
    table, phases, sw, ptab, n_grid = _inputs(
        29 + mpr, k, log2_rows, pack, spc, False, 8
    )
    salts = tuple((0x9E3779B9 * (2 * i + 1)) & 0xFFFFFFFF for i in range(k))
    got_j, got_t = _run_both(
        table, phases, sw, ptab, n_grid, salts=salts, log2_rows=log2_rows,
        pack=pack, q=9, spc=spc, mpr=mpr, l16=12, prefix_on=True,
    )
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(a, b)
    r_s, w_s, cnt = got_t[0], got_t[1], got_t[4]
    assert int(cnt.sum()) > 0
    assert int((r_s >= 0).sum()) == int(np.minimum(cnt, mpr).sum())
    # the refinement zeroed some extracted words
    assert int(((r_s >= 0) & (w_s == 0)).sum()) > 0


@pytest.mark.parametrize("spc", range(1, 9))
def test_kernel_word_offsets_equal_plain_planes(spc):
    """The (phase, cell offset) table the wrapper hands the CUDA kernel
    reads the same word as the plain version's plane for every offset the
    kernel uses: the gram words ``[0, 4)`` and the prefix windows from
    ``c_min = -spc`` on, including the zero words before cell 0."""
    from php_aho_corasick_tpu_torch.ops.filter_cuda import (
        FUSED_OFF_BIAS, _plane_torch, _window_offsets, fused_word_offsets,
    )

    rng = np.random.default_rng(spc)
    rows = 3
    phases = torch.from_numpy(rng.integers(
        -(2**31), 2**31, (spc, rows + 8, 128), dtype=np.int64
    ).astype(np.int32))
    tot = rows * 128
    woff, dcell = fused_word_offsets(spc, (rows + 8) * 128)
    flat = phases.reshape(-1)
    g = torch.arange(tot)
    c_min = _window_offsets(spc)
    assert c_min == -spc
    # the kernel loads the prefix window's words from c_min + x0 // 4 on,
    # six of them at most (l16 <= 20): offsets up to 5
    for c in range(c_min, 6):
        i = c + FUSED_OFF_BIAS
        idx = woff[i] + g
        got = torch.where(g + dcell[i] >= 0, flat[idx.clamp(min=0)], 0)
        assert torch.equal(got, _plane_torch(phases, c, spc, tot)), c


@pytest.mark.parametrize("q", range(1, 17))
def test_kernel_gram_code_dp4a_equals_polynomial(q):
    """The kernel's code assembly (four dp4a byte products a word, partial
    sums joined by shifts) equals sum_j byte_j * GRAM_BASE^(q-1-j) mod
    2^32."""
    from php_aho_corasick_tpu_torch.ops.filter_cuda import gram_weight_bytes
    from php_aho_corasick_tpu_torch.ops.filter_torch import GRAM_BASE

    gb = gram_weight_bytes(q)

    def dp4a_code(words):
        # __dp4a(word, gb[c][m], acc[m]) summed over the words, then joined
        acc = [0, 0, 0, 0]
        for c, word in enumerate(words):
            for m in range(4):
                acc[m] += sum(((word >> (8 * k)) & 0xFF)
                              * ((gb[c][m] >> (8 * k)) & 0xFF)
                              for k in range(4))
        return (acc[0] + (acc[1] << 8) + (acc[2] << 16)
                + (acc[3] << 24)) % (1 << 32)

    rng = np.random.default_rng(q)
    n_words = (q - 1) // 4 + 1
    for _ in range(20):
        data = rng.integers(0, 256, 4 * n_words)
        data[: rng.integers(0, 4 * n_words)] = 255  # saturated bytes too
        words = [int(sum(int(data[4 * c + k]) << (8 * k) for k in range(4)))
                 for c in range(n_words)]
        want = sum(int(data[j]) * pow(GRAM_BASE, q - 1 - j, 1 << 32)
                   for j in range(q)) % (1 << 32)
        assert dp4a_code(words) == want
