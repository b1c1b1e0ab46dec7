"""Input pipeline (counterpart of ``euler_tpu.parallel``): the prefetch
workers of ``train.train``. Multi-device training is not ported yet
(ROADMAP A10)."""

from euler_tpu_torch.parallel.prefetch import prefetch

__all__ = ["prefetch"]
