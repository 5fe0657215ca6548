"""Steady-state serving with device-resident corpora.

The reference's scale story is one automaton amortized over many
haystacks (its ``README.md:7-9``).  The device dual is
amortizing the *upload*: ``Matcher.device_corpus`` packs and transfers a
corpus once, and every subsequent ``match_arrays`` call against the
handle re-scans resident bytes at engine speed.  For throughput serving,
``match_arrays_many`` pipelines several handles through one trailing
fetch of their counts.

    python -m php_aho_corasick_tpu_torch.examples.serving_loop
"""

import random
import time

from php_aho_corasick_tpu_torch import Matcher, ScanConfig


def main(device="cuda", n_signatures=512, doc_bytes=8192, n_docs=64):
    """Returns document 3's records (a signature is planted there)."""
    rng = random.Random(7)
    signatures = sorted(
        {
            bytes(rng.choice(b"abcdefgh") for _ in range(16))
            for _ in range(n_signatures)
        }
    )
    matcher = Matcher(
        [{"id": i, "value": s} for i, s in enumerate(signatures)],
        ScanConfig(backend="device"),
        device=device,
    )
    matcher.finalize()

    # one batch of documents arrives; pay pack + upload once
    docs = [bytes(rng.choices(b"abcdefgh", k=doc_bytes))
            for _ in range(n_docs)]
    planted = signatures[42 % len(signatures)]
    docs[3] = docs[3][:100] + planted + docs[3][100:]
    handle = matcher.device_corpus(docs)
    print(handle)

    # re-scan the resident corpus (e.g. after a policy change, or for
    # several independent queries) without re-uploading
    t0 = time.time()
    res = matcher.match_arrays(handle)
    print(
        f"single scan: {res['doc'].shape[0]} matches "
        f"in {(time.time() - t0) * 1e3:.1f} ms"
    )

    # pipelined high-throughput loop over several resident corpora
    handles = [handle] * 4
    t0 = time.time()
    outs = matcher.match_arrays_many(handles)
    dt = (time.time() - t0) / len(handles)
    total = sum(o["doc"].shape[0] for o in outs)
    print(
        f"pipelined x{len(handles)}: {total} matches, "
        f"{dt * 1e3:.1f} ms/corpus "
        f"({handle.total_bytes / dt / 1e9:.2f} GB/s)"
    )

    # handles interoperate with the dict API too
    recs = matcher.match_many(handle)
    print("doc 3 records:", recs[3])

    # steady-state streamed serving: batch k+1's device chains dispatch
    # before batch k's records expand on the host, so the device never
    # idles behind host emission — the right loop for match-dense feeds
    batches = [[handle] * 2 for _ in range(3)]
    t0 = time.time()
    n_stream = sum(
        o["doc"].shape[0]
        for out in matcher.match_arrays_stream(batches)
        for o in out
    )
    dt = (time.time() - t0) / 6
    print(
        f"streamed 3x2 batches: {n_stream} matches, "
        f"{dt * 1e3:.1f} ms/corpus"
    )

    # on several cards, shard the resident corpus over them (each card
    # holds 1/N of the rows and runs its own chain):
    # device_corpus(docs, shard=True)
    return recs[3]


if __name__ == "__main__":
    main()
