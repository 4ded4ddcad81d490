"""Mid-run checkpoint and resume.

Counterpart of ``xrdslam_tpu/engine/checkpoint.py``. A checkpoint is a
pickle of numpy arrays and plain Python values, never of torch tensors, so
that a file written on the card resumes on the CPU and the other way
round: the format version, the algorithm's class name, the index of the
last frame done, the algorithm's whole state and the pipeline's own
(``extra``: the relative-pose anchors, the frame times and the device pose
history of the group path). It is written through ``<path>.tmp`` and
``os.replace``, so that a crash while saving leaves the previous
checkpoint whole.

Each algorithm gives its state as a dict of host copies,
``checkpoint_state()``, and takes it back with ``restore_state(d)``, which
writes the device tensors in place (optimisers and captured CUDA graphs
hold their addresses) and takes the entries it knows out of ``d``; what is
left is reported and skipped. The keys are the JAX package's attribute
names where the state is the same.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

CKPT_VERSION = 1


def save_checkpoint(path: str, algorithm: Any, frame_idx: int, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``algorithm``'s state after frame ``frame_idx`` and the
    pipeline's ``extra`` to ``path``, atomically."""
    state = {
        "version": CKPT_VERSION,
        "algorithm": type(algorithm).__name__,
        "frame_idx": int(frame_idx),
        "attrs": algorithm.checkpoint_state(),
        "extra": dict(extra or {}),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str, algorithm: Any, want_extra: bool = False):
    """Restore the state at ``path`` into a freshly built ``algorithm``;
    returns the index of the last frame done (with ``want_extra``, that and
    the pipeline's ``extra``). A file of another format version, or written
    by another algorithm, raises ``ValueError`` before anything is
    restored; entries the algorithm does not know are skipped with a
    message."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    ver = state.get("version")
    if ver != CKPT_VERSION:
        raise ValueError(f"checkpoint {path} is version {ver}; this build reads version {CKPT_VERSION}")
    algo_name = state.get("algorithm")
    if algo_name != type(algorithm).__name__:
        raise ValueError(f"checkpoint {path} was written by {algo_name}, refusing to restore into "
                         f"{type(algorithm).__name__}")
    attrs = dict(state["attrs"])
    algorithm.restore_state(attrs)
    for attr in attrs:
        print(f"[checkpoint] skipping unknown attr {attr!r}", flush=True)
    if want_extra:
        return int(state["frame_idx"]), state.get("extra", {})
    return int(state["frame_idx"])
