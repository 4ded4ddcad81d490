"""Model base: a scene representation and its renderer as an ``nn.Module``.

Counterpart of ``xrdslam_tpu/models/base.py``. The reference package keeps
parameters in an explicit pytree; here the module owns them, and
``param_groups`` names them by optimizer group.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Type

import numpy as np
import torch
from torch import nn

from ..common.camera import Camera
from ..configs.base import InstantiateConfig


@dataclass
class ModelConfig(InstantiateConfig):
    _target: Type = field(default_factory=lambda: Model)


class Model(nn.Module):
    def __init__(self, config: ModelConfig, camera: Camera, bounding_box: np.ndarray, **kwargs) -> None:
        super().__init__()
        self.config = config
        self.camera = camera
        self.bounding_box = np.asarray(bounding_box, np.float32)

    def param_groups(self) -> Dict[str, List[torch.Tensor]]:
        """{optimizer group name: [parameters]}."""
        raise NotImplementedError

    def get_loss(self, *args, **kwargs):
        raise NotImplementedError
