"""Model zoo (counterpart of ``euler_tpu.models``)."""

from euler_tpu_torch.models.base import Model, ModelOutput
from euler_tpu_torch.models.graphsage import SupervisedGraphSage

__all__ = ["Model", "ModelOutput", "SupervisedGraphSage"]
