"""Online embedding inference support for ``euler_tpu_torch/serve.py``
(counterpart of ``euler_tpu/serving``).

The serving stack is three small layers:

* :class:`MicroBatcher` — request-level coalescing: concurrent embed
  queries merge into one padded-bucket device dispatch (flush on
  ``max_batch`` unique ids or ``max_wait_us``), with bounded admission
  (queue cap -> BUSY shedding) and per-request deadline enforcement.
* :class:`SLOTracker` — p50/p99 of served request latency against a
  configured target.
* :class:`EmbedFrontend` / :class:`EmbedClient` — a line-delimited JSON
  TCP protocol carrying base64 float32 embeddings (bit-exact through
  the wire), a live ``stats`` op, and SIGTERM-style drain.

Telemetry rides the engine's native histogram map (keys
``serve:<phase>`` and ``serve_batch``) and counters (``serve_*``), so
``telemetry.metrics_text()`` picks the serving path up.
"""

from euler_tpu_torch.serving.microbatch import (
    BusyError,
    DeadlineError,
    MicroBatcher,
)
from euler_tpu_torch.serving.slo import SLOTracker
from euler_tpu_torch.serving.frontend import EmbedClient, EmbedFrontend

# Serve-only CLI flags, shared between `python -m euler_tpu_torch.serve`
# and run_loop's --serve_after (and used by run_loop to reject them in a
# plain train run, where they would silently do nothing).
SERVE_FLAG_DEFAULTS = {
    "serve_host": "127.0.0.1",
    "serve_port": 9200,
    "serve_max_batch": 64,
    "serve_max_wait_us": 2000,
    "serve_queue_cap": 128,
    "serve_slo_ms": 100.0,
    "serve_max_conns": 64,
    "serve_sample_cache": 65536,
    "serve_deadline_ms": 0,
    "serve_strict_bucket": 0,
}


def add_serve_flags(p):
    """Define the serving flag surface on an argparse parser (defaults
    from SERVE_FLAG_DEFAULTS, which run_loop audits overrides against)."""
    d = SERVE_FLAG_DEFAULTS
    p.add_argument("--serve_host", default=d["serve_host"], help=(
        "address the embedding frontend binds"))
    p.add_argument("--serve_port", type=int, default=d["serve_port"],
                   help="embedding frontend port (0 = ephemeral)")
    p.add_argument("--serve_max_batch", type=int,
                   default=d["serve_max_batch"], help=(
        "unique ids per micro-batch device dispatch; concurrent "
        "requests coalesce up to this"))
    p.add_argument("--serve_max_wait_us", type=int,
                   default=d["serve_max_wait_us"], help=(
        "micro-batch flush window: a request waits at most this long "
        "for co-batchable traffic before dispatching"))
    p.add_argument("--serve_queue_cap", type=int,
                   default=d["serve_queue_cap"], help=(
        "bounded admission: requests queued beyond this are answered "
        "BUSY (serve_busy_rejects) instead of building unbounded "
        "latency"))
    p.add_argument("--serve_slo_ms", type=float, default=d["serve_slo_ms"],
                   help="latency SLO target the p50/p99 tracker reports "
                        "against")
    p.add_argument("--serve_max_conns", type=int,
                   default=d["serve_max_conns"], help=(
        "frontend connection cap; clients beyond it get one BUSY reply "
        "and a close"))
    p.add_argument("--serve_sample_cache", type=int,
                   default=d["serve_sample_cache"], help=(
        "per-id sampled-neighborhood cache entries (a served id's "
        "neighborhood is drawn once, seeded by id, and reused — "
        "deterministic embeddings and no repeat sampling for hot ids)"))
    p.add_argument("--serve_deadline_ms", type=int,
                   default=d["serve_deadline_ms"], help=(
        "default per-request deadline; a request not dispatched within "
        "it is answered DEADLINE (serve_deadline_rejects). 0 = none. "
        "Clients can override per request"))
    p.add_argument("--serve_strict_bucket", type=int,
                   default=d["serve_strict_bucket"], help=(
        "bucket guard severity: a dispatch whose shapes or dtypes "
        "differ from the captured bucket already bumps serve_recompiles "
        "and captures again; 1 makes it raise instead (the fixed-bucket "
        "forward is the bit-parity anchor: another bucket means the "
        "contract broke)"))
    return p


def serve_flag_overrides(args) -> list:
    """Names of serve-only flags set away from their defaults — the
    run_loop train-mode rejection list."""
    return sorted(
        f"--{name}" for name, default in SERVE_FLAG_DEFAULTS.items()
        if getattr(args, name, default) != default
    )


__all__ = [
    "BusyError", "DeadlineError", "MicroBatcher", "SLOTracker",
    "EmbedClient", "EmbedFrontend", "SERVE_FLAG_DEFAULTS",
    "add_serve_flags", "serve_flag_overrides",
]
