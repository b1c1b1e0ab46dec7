"""Model zoo (counterpart of ``euler_tpu.models``)."""

from euler_tpu_torch.models.base import Model, ModelOutput
from euler_tpu_torch.models.graphsage import GraphSage, SupervisedGraphSage
from euler_tpu_torch.models.shallow import LINE, Node2Vec

__all__ = ["GraphSage", "LINE", "Model", "ModelOutput", "Node2Vec",
           "SupervisedGraphSage"]
