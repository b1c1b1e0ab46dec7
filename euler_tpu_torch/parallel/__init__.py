"""Input pipelines (counterpart of ``euler_tpu.parallel``): the prefetch
workers of ``train.train`` and the split-sampler ring of its
``sampler_depth``. Multi-device training is not ported yet (ROADMAP
A10)."""

from euler_tpu_torch.parallel.prefetch import pipeline, prefetch

__all__ = ["pipeline", "prefetch"]
