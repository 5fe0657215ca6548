"""Bulk scanning: the "one automaton, many haystacks" production pattern
(the reference's intended amortization, its ``README.md:7-9``)
on the card — build once, warm the kernels, then stream corpora through
``match_many``.

    python -m php_aho_corasick_tpu_torch.examples.bulk_scan
"""

import random
import time

from php_aho_corasick_tpu_torch import Matcher, ScanConfig


def main(device="cuda", n_needles=2048, doc_bytes=1 << 20, n_docs=8,
         n_batches=3):
    """Returns the matches found in each batch."""
    rng = random.Random(0)
    needles = sorted(
        {bytes(rng.choice(b"abcdef") for _ in range(16))
         for _ in range(n_needles)}
    )
    m = Matcher(
        [{"id": i, "value": p} for i, p in enumerate(needles)],
        ScanConfig(backend="device", chunk_len=4096),
        device=device,
    )
    m.finalize()
    print(m.describe())

    # Build the hand kernels and size the device buffers for the serving
    # shape once, at startup.
    m.warmup(doc_bytes=doc_bytes, n_docs=n_docs)

    counts = []
    for batch in range(n_batches):
        docs = [bytes(rng.choices(b"abcdef", k=doc_bytes))
                for _ in range(n_docs)]
        # plant one needle so the batch has something to find
        docs[0] = docs[0][:500] + needles[batch] + docs[0][516:]
        t0 = time.time()
        results = m.match_many(docs)
        dt = time.time() - t0
        n = sum(len(r) for r in results)
        counts.append(n)
        mb = sum(map(len, docs)) / 2**20
        print(
            f"batch {batch}: {mb:.0f} MiB, {n} matches, "
            f"{dt * 1e3:.0f} ms  (engine stats: {m.stats.summary()})"
        )
    return counts


if __name__ == "__main__":
    main()
