"""The measurement tools: the JAX package's ``bench.py`` and
``benchmarks/`` scripts on the port, each printing its record as one JSON
line last.

- ``headline``: ``bench.py``'s record (pass ms and spread, GB/s, end to
  end, the cold path, build seconds, the match-density rows);
- ``signatures``: ``benchmarks/bench_signatures.py`` (1M-needle
  signature sets, ``--alphabet hex|byte``);
- ``stage_budget``: ``benchmarks/probe_stage_budget.py`` (the stage
  budget of the headline records pass);
- ``scaling``: ``benchmarks/bench_scaling.py`` (bytes/s over 1..N
  shards, ``--engine dfa|cascade``);
- ``reference_protocol``: ``benchmarks/benchmark_reference.py`` (the PHP
  extension's own protocol, build included).

Each runs as ``python -m php_aho_corasick_tpu_torch.bench.<tool>`` on the
card, or on the CPU with ``--device cpu``; with no card and no
``--device cpu`` it raises.  A tool writes a file only to ``--artifact
PATH``.  On a card it first runs its workload once with every hand-kernel
launch held against the kernel's plain version on the same inputs, and
its record gives each kernel's launches and largest difference.
"""
