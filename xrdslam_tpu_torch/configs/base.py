"""Config primitives: printable + instantiatable dataclass configs.

Mirrors the reference's nerfstudio-style config-as-code pattern
(reference: slam/configs/base_config.py:12-37): every component class ``X``
has a ``@dataclass XConfig(InstantiateConfig)`` with ``_target: Type = X``
and ``config.setup(**kwargs)`` builds ``X(config, **kwargs)``.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Type


@dataclass
class PrintableConfig:
    """A dataclass config that pretty-prints itself recursively."""

    def __str__(self) -> str:
        lines = [self.__class__.__name__ + ":"]
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, PrintableConfig):
                sub = str(val).split("\n")
                lines.append(f"  {f.name}:")
                lines.extend("  " + s for s in sub[1:])
            else:
                lines.append(f"  {f.name}: {val!r}")
        return "\n".join(lines)

    def copy(self) -> "PrintableConfig":
        return copy.deepcopy(self)


@dataclass
class InstantiateConfig(PrintableConfig):
    """Config that can instantiate its ``_target`` class."""

    _target: Type = field(default_factory=lambda: object)

    def setup(self, **kwargs) -> Any:
        """Instantiate the target class with this config."""
        return self._target(config=self, **kwargs)
