"""The operator's tools (counterparts of the JAX package's ``scripts/``
runbook tools), each a module with the JAX script's name, flags,
functions and output:

    python -m euler_tpu_torch.scripts.metrics_dump   scrape a live cluster
    python -m euler_tpu_torch.scripts.trace_dump     merged Chrome trace
    python -m euler_tpu_torch.scripts.postmortem     incident timeline
    python -m euler_tpu_torch.scripts.heat_dump      data-plane skew report
    python -m euler_tpu_torch.scripts.devprof_dump   device-plane report
    python -m euler_tpu_torch.scripts.epoch_drill    rolling graph refresh
    python -m euler_tpu_torch.scripts.serve_drill    closed-loop serving

Each ``--smoke`` (and ``heat_dump --ab-smoke``) is a self-contained check
that exits non-zero when it fails. A tool that touches the card takes
``--device`` (``cuda`` unless ``cpu`` is asked for; with no card it
raises).
"""
