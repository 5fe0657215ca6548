"""The reference's six conformance tests (``tests/test_golden_php.py``) over
the port's PHP-parity functions and ``Matcher`` on the CPU, for the host
scan and the device engines (the tile engine serves these small
automata).  The expectation blocks are the JAX package's tests' own."""

import pytest

torch = pytest.importorskip("torch")

from test_golden_php import (  # noqa: E402
    AUX1,
    TEST1_EXPECT,
    TEST1_PATTERNS,
    TEST2_EXPECT,
    TEST2_PATTERNS,
    TEST2_STR,
    assert_records,
)

import php_aho_corasick_tpu_torch as port  # noqa: E402
from php_aho_corasick_tpu_torch import (  # noqa: E402
    ahocorasick_add_patterns,
    ahocorasick_deinit,
    ahocorasick_init,
    ahocorasick_isValid,
    ahocorasick_match,
)


def _matcher(patterns, backend):
    return port.Matcher(patterns, port.ScanConfig(backend=backend),
                        device="cpu")


def test1_core_matching(backend):
    c = _matcher(TEST1_PATTERNS, backend)
    d1 = c.match("alFABETA gamma zetaomegaalfa!")
    assert c.close()
    assert_records(d1, TEST1_EXPECT)
    assert len(d1) == 5
    assert d1[4] == {"pos": 28, "start_postion": 25, "value": "lfa"}
    if backend == "device":
        assert c.stats.last_engine == "tile"


def test1_utf8_byte_positions(backend):
    c = _matcher(
        [{"value": "你好"}, {"value": "hi"}, {"value": "谢谢"},
         {"value": "thanks"}],
        backend,
    )
    res = c.match("你好，hi，谢谢，thanks")
    assert_records(
        res,
        [
            {"pos": 6, "start_postion": 0, "value": "你好"},
            {"pos": 11, "start_postion": 9, "value": "hi"},
            {"pos": 20, "start_postion": 14, "value": "谢谢"},
            {"pos": 29, "start_postion": 23, "value": "thanks"},
        ],
    )
    assert c.close()


def test2_aux_and_lifecycle(backend):
    c = ahocorasick_init(TEST2_PATTERNS, device="cpu")
    assert c is not False
    c.config = port.ScanConfig(backend=backend)

    d = ahocorasick_match(TEST2_STR, c)
    assert_records(d, TEST2_EXPECT)
    assert len(d) == 16
    # aux objects are shared by reference, not copied
    assert d[6]["aux"] is AUX1

    assert ahocorasick_match("alFABETAABECEDAAAA!", c) == []
    assert ahocorasick_match("alFABETAABECEDAAAA!", c, False) == []
    assert ahocorasick_match("alFABETAABECEDAAAA!", c, True) == []

    assert ahocorasick_isValid(c) is True
    assert ahocorasick_deinit(c) is True
    assert ahocorasick_isValid(c) is False
    assert ahocorasick_deinit(c) is False


def test3_incremental_build(backend):
    c = ahocorasick_init([], device="cpu")
    assert c is not False
    c.config = port.ScanConfig(backend=backend)
    assert ahocorasick_add_patterns(c, [{"key": "ab", "value": "alfa"}])
    assert ahocorasick_add_patterns(c, [{"key": "ac", "value": "beta"}])
    assert ahocorasick_add_patterns(
        c, [{"key": "ad", "value": "gamma", "aux": [1]}])
    assert ahocorasick_add_patterns(c, [{"key": "ae", "value": "delta"}])
    assert ahocorasick_add_patterns(
        c,
        [
            {"id": 0, "value": "zeta"},
            {"key": "ag", "value": "omega"},
            {"value": "lfa"},
        ],
    )
    d1 = ahocorasick_match("alFABETA gamma zetaomegaalfa!", c)
    assert ahocorasick_deinit(c)
    assert_records(d1, TEST1_EXPECT)


def test4_stress_repeated_lifecycle(backend):
    s = "aoeu a5 a5 a5 a5 aoeu"
    n_inner = 1000 if backend == "host" else 25
    for _ in range(20):
        c = _matcher([{"value": "a5"}], backend)
        for _ in range(n_inner):
            d = c.match(s)
            assert len(d) == 4
        assert c.close()


def test5_multibyte_no_state_pollution(backend):
    data = [
        {"key": "熊本県熊本市北区四方寄町", "value": "北区四方寄町"},
        {"key": "熊本県熊本市北区立福寺町", "value": "北区立福寺町"},
    ]
    haystacks = [
        "東京都東京都", "兵庫県兵庫県", "奈良県奈良県", "兵庫県兵庫県",
        "兵庫県兵庫県", "兵庫県兵庫県", "兵庫県兵庫県", "埼玉県埼玉県",
        "兵庫県兵庫県", "兵庫県兵庫県", "兵庫県兵庫県", "東京都東京都",
        "愛知県、大阪府愛知県", "墨田区錦糸町駅前東京都墨田区錦糸町駅",
        "東京都渋谷区東京都渋谷区",
    ]
    c = _matcher(data, backend)
    for h in haystacks:
        assert c.match(h) == []
    assert c.match("熊本県熊本市北区四方寄町")[0]["value"] == "北区四方寄町"


def test6_no_state_bleed_between_calls(backend):
    data = [
        {"key": "a", "value": "abcd"},
        {"key": "b", "value": "ghij"},
        {"key": "c", "value": "defg"},
        {"key": "d", "value": "defghijkl"},
    ]
    c = _matcher(data, backend)
    first = c.match("abcde")
    second = c.match("fghij")
    third = c.match("klmno")
    assert c.close()
    assert_records(
        first, [{"pos": 4, "key": "a", "start_postion": 0, "value": "abcd"}]
    )
    assert_records(
        second, [{"pos": 5, "key": "b", "start_postion": 1, "value": "ghij"}]
    )
    assert third == []


def test_compat_failure_convention():
    """Structural failures warn and return False, as the reference's."""
    with pytest.warns(Warning):
        assert ahocorasick_match("abc", object()) is False
    with pytest.warns(Warning):
        assert ahocorasick_init([{"key": "x"}], device="cpu") is False
    with pytest.raises(port.AhoError):  # a type error raises
        ahocorasick_init([{"value": 5}], device="cpu")
    c = ahocorasick_init(["ab"], device="cpu")
    assert port.ahocorasick_finalize(c) is True
    assert port.ahocorasick_finalize(c) is False
    with pytest.warns(Warning):
        assert ahocorasick_add_patterns(c, ["cd"]) is False
