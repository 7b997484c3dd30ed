"""Checkpoints: the reference's `.rsr` and resumable torch checkpoints.

The reference writes the flat float32 vector to `.rsr` every 100 steps
and restarts from bare parameters (``--start``).  A native checkpoint
also holds Adam's state and the step counter, so that a run continues
where it stopped (`rusty_sr_tpu/train/checkpoint.py` does this with
orbax).  Here it is one file, ``step_%08d``, written by `torch.save` to a
temporary name and moved into place with `os.replace`, so a crash mid-save
never leaves a partial ``step_*`` file; it holds the 19 reference
tensors (float32, CPU, HWIO), the optimizer's ``state_dict`` and the
step, and is read back with ``weights_only=True``.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from rusty_sr_tpu_torch import params as params_lib


def save_rsr(path: str, params, factor: int) -> None:
    """The reference-format checkpoint of a numpy tree."""
    params_lib.save_rsr_file(path, {k: np.asarray(v) for k, v in
                                    params.items()}, factor)


def _to_cpu(obj):
    """Tensors (and numpy arrays) of a nested state moved to CPU tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj))
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_native(ckpt_dir: str, step: int, params, opt_state=None) -> str:
    """Write ``step_%08d`` under ``ckpt_dir``: the parameter tree, the
    optimizer state (a ``state_dict``, or None) and the step.  Returns
    its path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    payload = {"params": {k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in params.items()},
               "step": int(step)}
    if opt_state is not None:
        payload["opt_state"] = _to_cpu(opt_state)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def latest_native(ckpt_dir: str) -> Optional[str]:
    """The newest ``step_N`` checkpoint under ``ckpt_dir``, or None.  Only
    names that are ``step_`` and digits count: a temporary file left by a
    crash mid-save sorts after them and must not be resumed from."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if re.fullmatch(r"step_\d+", d))
    return os.path.join(os.path.abspath(ckpt_dir), steps[-1]) if steps \
        else None


def _load(path: str) -> dict:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path!r} is not a training checkpoint")
    return payload


def checkpoint_keys(path: str) -> set:
    """Top-level keys of a checkpoint ("params", "step" and, where it
    holds one, "opt_state"), so that resume decides from the file whether
    there is optimizer state, never from a failed restore."""
    return set(_load(path))


def restore_native(path: str, like_params=None) -> Tuple[dict, object, int]:
    """-> (numpy parameter tree, optimizer state dict or None, step).
    With ``like_params``, the stored tree must have its names and shapes,
    or ValueError (e.g. factor-2 weights into a factor-3 run)."""
    payload = _load(path)
    tree = {k: v.numpy() for k, v in payload["params"].items()}
    if like_params is not None:
        want = {k: tuple(np.shape(v)) for k, v in like_params.items()}
        got = {k: tuple(v.shape) for k, v in tree.items()}
        if got != want:
            raise ValueError(f"parameter shapes {got} do not match the "
                             f"run's {want}")
    return tree, payload.get("opt_state"), int(payload["step"])


def check_adam_state(opt_state, like_params) -> None:
    """ValueError unless ``opt_state`` is an Adam ``state_dict`` whose
    moments have the shapes of ``like_params`` (in their order);
    ``load_state_dict`` itself checks only the count of parameters."""
    if not isinstance(opt_state, dict) or "state" not in opt_state:
        raise ValueError("the optimizer state is not a torch state_dict")
    shapes = [tuple(np.shape(v)) for v in like_params.values()]
    for i, st in opt_state["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            if tuple(st[key].shape) != shapes[int(i)]:
                raise ValueError(f"Adam {key} of parameter {i} has shape "
                                 f"{tuple(st[key].shape)}, not "
                                 f"{shapes[int(i)]}")
