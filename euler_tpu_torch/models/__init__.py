"""Model zoo (counterpart of ``euler_tpu.models``)."""

from euler_tpu_torch.models.base import (Model, ModelOutput,
                                         ScalableStoreModel)
from euler_tpu_torch.models.gat import GAT
from euler_tpu_torch.models.gcn import ScalableGCN, SupervisedGCN
from euler_tpu_torch.models.graphsage import (GraphSage, ScalableSage,
                                              SupervisedGraphSage)
from euler_tpu_torch.models.lasgnn import LasGNN
from euler_tpu_torch.models.lshne import LsHNE
from euler_tpu_torch.models.shallow import LINE, Node2Vec

__all__ = ["GAT", "GraphSage", "LINE", "LasGNN", "LsHNE", "Model",
           "ModelOutput", "Node2Vec", "ScalableGCN", "ScalableSage",
           "ScalableStoreModel", "SupervisedGCN", "SupervisedGraphSage"]
