"""Host-side ops (counterpart of ``euler_tpu.ops``), with its surface: a
user model samples through these (the extension API of
``examples/custom_sage_reddit.py``)."""

from euler_tpu_torch.ops.feature import (
    get_dense_feature,
    get_edge_dense_feature,
    get_sparse_feature,
)
from euler_tpu_torch.ops.neighbor import (
    MultiHop,
    get_multi_hop_neighbor,
    sample_fanout,
    sample_neighbor,
)
from euler_tpu_torch.ops.sample import (sample_edge, sample_node,
                                        sample_node_with_src)
from euler_tpu_torch.ops.walk import gen_pair, random_walk

__all__ = [
    "MultiHop",
    "get_multi_hop_neighbor",
    "sample_fanout",
    "sample_neighbor",
    "get_dense_feature",
    "get_edge_dense_feature",
    "get_sparse_feature",
    "sample_edge",
    "sample_node",
    "sample_node_with_src",
    "gen_pair",
    "random_walk",
]
