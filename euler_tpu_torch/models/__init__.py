"""Model zoo (counterpart of ``euler_tpu.models``)."""

from euler_tpu_torch.models.base import Model, ModelOutput
from euler_tpu_torch.models.graphsage import GraphSage, SupervisedGraphSage

__all__ = ["GraphSage", "Model", "ModelOutput", "SupervisedGraphSage"]
