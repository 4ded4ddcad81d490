"""Dataclass-driven CLI: a dependency-free stand-in for tyro.

The reference generates its entire CLI (subcommands, flags, defaults, help)
from the dataclass config tree with tyro (reference: scripts/run.py:26-32,
slam/configs/input_config.py:495-498). tyro is not available here, so this
module walks a registry of config instances and builds an ``argparse`` parser
with the same surface: one subcommand per algorithm, and dotted flags like
``--xrdslam.tracker.map-every 5`` for every leaf field.

Only leaf fields of simple types (int/float/str/bool/Path and flat or nested
float/int lists) become flags; nested ``PrintableConfig`` fields recurse.
"""
from __future__ import annotations

import argparse
import ast
import copy
import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from .base import PrintableConfig

_SCALARS = (int, float, str, bool, Path)


def _is_config(val: Any) -> bool:
    return isinstance(val, PrintableConfig)


def _flag_name(dotted: str) -> str:
    return "--" + dotted.replace("_", "-")


def _collect_leaves(cfg: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a config instance into {dotted_name: value} for leaf fields."""
    leaves: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        if f.name.startswith("_"):
            continue
        val = getattr(cfg, f.name)
        dotted = f"{prefix}{f.name}"
        if _is_config(val):
            leaves.update(_collect_leaves(val, dotted + "."))
        elif isinstance(val, dict):
            continue  # optimizer config dicts are not CLI-exposed (same as reference defaults)
        else:
            leaves[dotted] = val
    return leaves


def _parse_value(text: str, default: Any) -> Any:
    """Parse a CLI string according to the default value's type."""
    if isinstance(default, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int) and not isinstance(default, bool):
        return int(text)
    if isinstance(default, float):
        return float(text)
    if isinstance(default, Path):
        return Path(text)
    if isinstance(default, (list, tuple)) or default is None and text.startswith("["):
        return ast.literal_eval(text)
    if default is None:
        # try literal first (numbers, lists), else keep string
        try:
            return ast.literal_eval(text)
        except (ValueError, SyntaxError):
            return text
    return text


def _set_dotted(cfg: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    setattr(obj, parts[-1], value)


def build_parser(registry: Dict[str, Any], descriptions: Optional[Dict[str, str]] = None, prog: str = "ds-run") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=prog, description="Neural SLAM on PyTorch/CUDA (xrdslam_tpu_torch)")
    sub = parser.add_subparsers(dest="algorithm", required=True)
    descriptions = descriptions or {}
    for name, cfg in registry.items():
        p = sub.add_parser(name, help=descriptions.get(name, ""), formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        for dotted, default in _collect_leaves(cfg).items():
            p.add_argument(
                _flag_name(dotted),
                dest=dotted,
                type=str,
                default=argparse.SUPPRESS,
                help=f"(default: {default!r})",
                metavar=str(type(default).__name__ if default is not None else "val"),
            )
    return parser


def parse_config(registry: Dict[str, Any], argv=None, descriptions: Optional[Dict[str, str]] = None) -> Tuple[Any, argparse.Namespace]:
    """Parse argv into a deep-copied, override-applied config instance."""
    parser = build_parser(registry, descriptions)
    args = parser.parse_args(argv)
    cfg = copy.deepcopy(registry[args.algorithm])
    defaults = _collect_leaves(cfg)
    for dotted, default in defaults.items():
        if hasattr(args, dotted):
            _set_dotted(cfg, dotted, _parse_value(getattr(args, dotted), default))
    return cfg, args
