"""Basic usage — the analog of the reference's inline example
(its ``README.md:72-94``), in both API styles.

    python -m php_aho_corasick_tpu_torch.examples.basic
"""

from php_aho_corasick_tpu_torch import (
    Matcher,
    ahocorasick_deinit,
    ahocorasick_init,
    ahocorasick_match,
)

DATA = [
    {"key": "ab", "value": "alfa"},
    {"key": "ac", "value": "beta"},
    {"key": "ad", "value": "gamma", "aux": [1]},
    {"key": "ae", "value": "delta"},
    {"id": 0, "value": "zeta"},
    {"key": "ag", "value": "omega"},
    {"value": "lfa"},
]


def main(device="cuda") -> None:
    # ---- PHP-parity procedural style ----
    c = ahocorasick_init(DATA, device=device)
    for rec in ahocorasick_match("alFABETA gamma zetaomegaalfa!", c):
        print(rec)
    ahocorasick_deinit(c)

    # ---- Pythonic style ----
    with Matcher(DATA, device=device) as m:
        print("\nbatched:",
              [len(r) for r in m.match_many(["alfa!", "", "zeta zeta"])])
        print("first only:", m.match("gamma gamma", find_all=False))
        print("replace:", m.replace("alfa beta", {"alfa": "ALFA"}))
        with m.stream() as st:
            a = st.feed("al")  # no match yet ...
            b = st.feed("fa")  # ... completed across the feed boundary
            print("stream:", a, b)
        print(m.describe())


if __name__ == "__main__":
    main()
