"""Camera intrinsics (reference: slam/common/camera.py:5-11)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    height: int
    width: int
