"""Runnable examples of the port, the counterparts of the JAX package's
``examples/``:

    python -m php_aho_corasick_tpu_torch.examples.basic
    python -m php_aho_corasick_tpu_torch.examples.bulk_scan
    python -m php_aho_corasick_tpu_torch.examples.serving_loop

Each runs on CUDA; its ``main`` takes ``device`` (``"cpu"`` runs it on the
CPU) and its sizes, the JAX examples' sizes by default.
"""
