"""Graph storage and device sampling (counterpart of ``euler_tpu.graph``):
``Graph`` is the engine client over ``.dat`` files, ``MemoryGraph`` an
in-memory graph over CSR arrays; both answer the table builders' reads."""

from euler_tpu_torch.graph.graph import Graph
from euler_tpu_torch.graph.memory import MemoryGraph

__all__ = ["Graph", "MemoryGraph"]
