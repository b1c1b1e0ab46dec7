"""Graph storage and device sampling (counterpart of ``euler_tpu.graph``):
``Graph`` is the engine client (local ``.dat`` files, or a sharded
service in ``mode="remote"``), ``GraphService`` one shard of that
service, ``MemoryGraph`` an in-memory graph over CSR arrays; all answer
the device tables' reads."""

from euler_tpu_torch.graph.graph import Graph
from euler_tpu_torch.graph.memory import MemoryGraph
from euler_tpu_torch.graph.service import GraphService

__all__ = ["Graph", "GraphService", "MemoryGraph"]
