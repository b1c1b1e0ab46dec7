"""Graph storage and device sampling (counterpart of ``euler_tpu.graph``)."""

from euler_tpu_torch.graph.graph import Graph

__all__ = ["Graph"]
