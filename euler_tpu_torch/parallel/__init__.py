"""Input pipelines and multi-device training (counterpart of
``euler_tpu.parallel``): the prefetch workers of ``train.train`` and the
split-sampler ring of its ``sampler_depth``, and the ``(data, model)``
mesh of ranks over ``torch.distributed`` (``mesh``)."""

from euler_tpu_torch.parallel.mesh import (Mesh, RowShard, init_distributed,
                                           launch, make_mesh,
                                           pad_tables_for_mesh, shard_batch,
                                           shard_state,
                                           shutdown_distributed)
from euler_tpu_torch.parallel.prefetch import pipeline, prefetch

__all__ = ["Mesh", "RowShard", "init_distributed", "launch", "make_mesh",
           "pad_tables_for_mesh", "pipeline", "prefetch", "shard_batch",
           "shard_state", "shutdown_distributed"]
