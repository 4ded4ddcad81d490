"""Run entry point.

Usage: python -m xrdslam_tpu_torch.scripts.run co-slam --data-type synthetic
       --data "n_frames=60,height=340,width=600,scene=office" [--dotted.overrides ...]

``--xrdslam.device`` selects the device (default ``cuda``; ``cpu`` for the
plain twins).
"""
from __future__ import annotations

import sys

from ..configs.cli import parse_config
from ..configs.registry import algorithm_configs, descriptions


def main(argv=None):
    """Parse, run, and return the finished runner."""
    config, _ = parse_config(algorithm_configs, argv, descriptions)
    print(config)
    runner = config.setup()
    runner.run()
    return runner


def entrypoint() -> None:
    main(sys.argv[1:])


if __name__ == "__main__":
    entrypoint()
