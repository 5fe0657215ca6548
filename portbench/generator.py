"""The one generator of every traffic mix.

A mix is a data file, ``traffic/<mix>.json``; a cell's file,
``workloads/<cell>.json``, may override any of its parameters under
``"params"``.  The generator draws everything from the run's seed: one
seed gives the same needles, documents, plants and arrivals, and every
seed gives the same sizes, the same number of plants and the same set of
gaps between arrivals (in another order).

Parameters (all sizes in bytes).  What the calls scan:

- ``units``: ``"resident"``: ``resident_units`` handles of
  ``unit_bytes`` each are drawn and uploaded once, in set-up, and call
  ``i`` scans ``units_per_call`` of them in turn (handles ``i*k`` to
  ``i*k + k - 1`` modulo ``resident_units``); ``"fresh"``: a pool of
  ``pool`` batches of ``docs_per_call`` documents is drawn in set-up, and
  call ``i`` hands batch ``i mod pool`` to the system anew;
- ``doc_bytes``: the length of every document;
- ``plants``: ``{"per_byte": r}`` plants ``int(r * bytes)`` needles in
  each handle or batch, ``{"count": n}`` plants ``n``; each plant takes a
  random needle at a random document and offset, never across the end of
  a document (a later plant may overwrite an earlier one).

How a call reaches the system (``system.py``):

- ``call``: the public entry that a call drives: ``"match_arrays_many"``
  (the call's handles in one call), ``"match_arrays"`` (one handle or
  one fresh batch a call), ``"match_arrays_stream"`` (the call's handles
  as one stream of batches of ``stream_batch`` handles);
- ``matcher``: ``"once"`` (built in set-up), ``"per_call"`` (built, used
  and closed inside every call, as a caller that builds per sample;
  fresh units only), ``"saved"`` (loaded in set-up from a file that the
  first run of a checkout builds and saves under ``build/portbench/``;
  the configuration fixes its needles with ``needles.seed``).

When calls start:

- ``loop``: ``{"kind": "closed"}``: one client, which issues a call as
  soon as the one before has returned; ``{"kind": "open", "rate_per_s":
  r}``: calls arrive at the mean rate ``r``, the gaps between arrivals
  being :data:`GAPS` quantiles of the exponential distribution in an
  order drawn from the seed; a call starts at its arrival, or when the
  one before it has returned if that is later, and its latency counts
  from its arrival.

The needles (``needles`` of the configuration: ``count`` distinct byte
strings of ``length`` symbols of ``alphabet``) are sorted, so a needle's
index, its pattern id, does not depend on the order of drawing.  The
documents' symbols are drawn on the run's device with a
``torch.Generator``, a unit in one call, and the plants with NumPy.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

FIELDS = {"units", "doc_bytes", "unit_bytes", "resident_units",
          "units_per_call", "docs_per_call", "pool", "plants", "call",
          "stream_batch", "matcher", "loop"}
CALLS = {"resident": ("match_arrays_many", "match_arrays",
                      "match_arrays_stream"),
         "fresh": ("match_arrays",)}
MATCHERS = ("once", "per_call", "saved")
#: the gaps between arrivals of an open loop, repeated in turn
GAPS = 1024
#: symbols looked up in the alphabet at once (bounds the int64 index)
LOOKUP_BLOCK = 1 << 24


def alphabet(spec: str) -> np.ndarray:
    """The symbols of an alphabet: ``"byte"`` (all 256) or the characters
    of the string itself (``"abcdef"``)."""
    if spec == "byte":
        return np.arange(256, dtype=np.uint8)
    return np.frombuffer(spec.encode("latin-1"), np.uint8).copy()


def symbols(rng: np.random.Generator, alpha: np.ndarray, shape) -> np.ndarray:
    """uint8 array of ``shape`` drawn uniformly from ``alpha``."""
    if alpha.size == 256:
        n = int(np.prod(shape))
        return np.frombuffer(rng.bytes(n), np.uint8).reshape(shape).copy()
    return alpha[rng.integers(0, alpha.size, size=shape, dtype=np.uint8)]


def device_symbols(gen: torch.Generator, alpha: np.ndarray, shape
                   ) -> np.ndarray:
    """uint8 array of ``shape`` drawn uniformly from ``alpha`` on the
    generator's device, in one call, and copied to the host."""
    dev = gen.device
    if alpha.size == 256:
        x = torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
    else:
        x = torch.randint(0, alpha.size, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
        table = torch.from_numpy(alpha).to(dev)
        flat = x.view(-1)
        for a in range(0, flat.numel(), LOOKUP_BLOCK):
            part = flat[a : a + LOOKUP_BLOCK]
            part.copy_(table[part.long()])
    return x.cpu().numpy()


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator a purpose, from any whole-number seed."""
    return np.random.default_rng(
        [seed % (1 << 64), *stream.encode()])


def needles(spec: dict, seed: int) -> np.ndarray:
    """``[count, length]`` uint8, distinct rows in ascending byte order,
    drawn from ``spec["seed"]`` where the configuration fixes it, else
    from the run's seed."""
    rng = rng_for(spec.get("seed", seed), "needles")
    alpha = alphabet(spec["alphabet"])
    count, length = spec["count"], spec["length"]
    if float(alpha.size) ** length < 2 * count:
        raise ValueError("the alphabet cannot give that many needles")
    rows = np.zeros((0, length), np.uint8)
    while rows.shape[0] < count:
        more = symbols(rng, alpha, (count - rows.shape[0], length))
        rows = np.unique(np.concatenate([rows, more]), axis=0)
    return rows


def plant(rng: np.random.Generator, docs: np.ndarray, pool: np.ndarray,
          plants: dict) -> int:
    """Write needles of ``pool`` into ``docs [n, D]`` in place; returns
    the number of plants."""
    n, D = docs.shape
    L = pool.shape[1]
    if "count" in plants:
        k = int(plants["count"])
    else:
        k = int(plants["per_byte"] * docs.size)
    d = rng.integers(0, n, k)
    off = rng.integers(0, D - L + 1, k)
    which = rng.integers(0, pool.shape[0], k)
    for i in range(k):
        docs[d[i], off[i] : off[i] + L] = pool[which[i]]
    return k


def params(mix: dict, overrides: dict) -> dict:
    """A mix's parameters with a cell's overrides, checked."""
    p = dict(mix)
    p.update(overrides)
    p.setdefault("matcher", "once")
    p.setdefault("loop", {"kind": "closed"})
    unknown = set(p) - FIELDS
    if unknown:
        raise ValueError(f"unknown traffic parameters {sorted(unknown)}")
    if p.get("units") not in CALLS:
        raise ValueError(f"unknown units {p.get('units')!r}")
    if p.get("call") not in CALLS[p["units"]]:
        raise ValueError(f"{p['units']} units cannot be scanned by "
                         f"{p.get('call')!r}")
    if p["matcher"] not in MATCHERS or (
            p["matcher"] == "per_call" and p["units"] != "fresh"):
        raise ValueError(f"matcher {p['matcher']!r} does not fit "
                         f"{p['units']} units")
    if p["loop"].get("kind") not in ("closed", "open") or (
            p["loop"]["kind"] == "open"
            and not p["loop"].get("rate_per_s", 0) > 0):
        raise ValueError(f"bad loop {p['loop']!r}")
    return p


def call_units(p: dict, i: int) -> List[int]:
    """The units (handles, or the one fresh batch) that call ``i`` scans."""
    if p["units"] == "fresh":
        return [i % p["pool"]]
    n, k = p["resident_units"], p["units_per_call"]
    return [(i * k + j) % n for j in range(k)]


def arrivals(p: dict, seed: int) -> Optional[Iterator[float]]:
    """The seconds from the window's start at which calls arrive, for an
    open loop; None for a closed one."""
    loop = p["loop"]
    if loop["kind"] == "closed":
        return None
    q = (np.arange(GAPS) + 0.5) / GAPS
    gaps = -np.log1p(-q) / float(loop["rate_per_s"])
    gaps = rng_for(seed, "arrivals").permutation(gaps)

    def gen() -> Iterator[float]:
        t, j = 0.0, 0
        while True:
            yield t
            t += float(gaps[j % GAPS])
            j += 1

    return gen()


def generate(p: dict, config: dict, seed: int, device="cpu"
             ) -> Dict[str, object]:
    """The run's inputs: ``needles`` (``[count, length]`` uint8) and
    ``units``, the document arrays ``[n, doc_bytes]`` uint8 that the calls
    hand to the system (the resident handles, or the pool of fresh
    batches), with ``planted`` the plants in each."""
    nd = needles(config["needles"], seed)
    alpha = alphabet(config["content"]["alphabet"])
    rng = rng_for(seed, "documents")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 1 << 63)))
    D = p["doc_bytes"]
    if p["units"] == "resident":
        shape = (p["unit_bytes"] // D, D)
        n_units = p["resident_units"]
    else:
        shape = (p["docs_per_call"], D)
        n_units = p["pool"]
    units: List[np.ndarray] = []
    planted: List[int] = []
    for _ in range(n_units):
        docs = device_symbols(gen, alpha, shape)
        planted.append(plant(rng, docs, nd, p["plants"]))
        units.append(docs)
    return {"needles": nd, "units": units, "planted": planted}
