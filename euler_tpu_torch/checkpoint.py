"""Checkpoint and resume of training state (counterpart of
``euler_tpu/checkpoint.py``), on torch state dicts.

A checkpoint is ``<dir>/<step>/state.pt``: the state's module and
optimizers as their ``state_dict()`` and its store tensors, written with
``torch.save`` to a scratch name and renamed into place, so a crash
leaves either the whole step or none of it. The device tables
(``consts``) are never saved: like the graph they come from, they are an
immutable input rebuilt from the graph at init. ``restore`` loads with
``torch.load(..., weights_only=True)`` onto the device of the state it
restores into.

Under a mesh (``parallel.mesh``) every rank calls ``save``: the stores'
row shards are gathered over the model axis and rank 0 writes the whole
padded tables, so the file is the one a single device would write for
padded stores. Every rank restores from it, each taking its own rows; a
restore needs the ``--model_parallel`` the checkpoint was saved under,
since the stores' padded shapes depend on it.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

_FILE = "state.pt"


def _device_of(state: dict) -> torch.device:
    module = state.get("module")
    if module is not None:
        for p in module.parameters():
            return p.device
    return torch.device("cpu")


def _to_saved(state: dict) -> dict:
    """The saved tree of a training state: every entry but ``consts``,
    modules and optimizers as their state dicts."""
    out = {}
    for k, v in state.items():
        if k == "consts":
            continue
        out[k] = v.state_dict() if hasattr(v, "state_dict") else v
    return out


class Checkpointer:
    """Periodic saver and latest-step restorer over one directory; keeps
    the newest ``max_to_keep`` steps."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3, mesh=None):
        self.dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.mesh = mesh

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        return sorted(
            int(n) for n in os.listdir(self.dir)
            if n.isdigit() and os.path.exists(
                os.path.join(self.dir, n, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> None:
        """Write step ``step``; an existing step is overwritten only with
        ``force``. Under a mesh every rank calls it and rank 0 writes."""
        if self.mesh is not None:
            from euler_tpu_torch.parallel.mesh import full_tables

            state = full_tables({k: v for k, v in state.items()
                                 if k != "consts"})
            if self.mesh.rank != 0:
                self.mesh.barrier()
                return
        try:
            self._write(step, state, force)
        finally:
            if self.mesh is not None:
                self.mesh.barrier()

    def _write(self, step: int, state: Any, force: bool) -> None:
        final = os.path.join(self.dir, str(int(step)))
        if os.path.exists(os.path.join(final, _FILE)) and not force:
            raise ValueError(
                f"step {step} already exists in {self.dir} (pass force=True "
                "to overwrite)")
        os.makedirs(final, exist_ok=True)
        tmp = os.path.join(final, _FILE + ".tmp")
        torch.save(_to_saved(state), tmp)
        os.replace(tmp, os.path.join(final, _FILE))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, str(old)),
                          ignore_errors=True)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Load step ``step`` (default: the latest) into ``state_like``,
        an initialised state of the same model and optimizer, in place,
        and return it. Its ``consts`` are kept as they are. Raises
        ``ValueError`` naming the directory when it holds no checkpoint
        or not that step, and when the saved tree does not match."""
        steps = self.all_steps()
        if step is None:
            if not steps:
                raise ValueError(
                    f"no checkpoint in {self.dir} (no saved steps — "
                    f"train with --model_dir={self.dir} first)")
            step = steps[-1]
        elif step not in steps:
            raise ValueError(
                f"no checkpoint for step {step} in {self.dir} "
                f"(available steps: {steps})")
        saved = torch.load(os.path.join(self.dir, str(step), _FILE),
                           map_location=_device_of(state_like),
                           weights_only=True)
        try:
            want = {k for k in state_like if k != "consts"}
            if set(saved) != want:
                raise KeyError(f"saved entries {sorted(saved)}, state "
                               f"entries {sorted(want)}")
            for k in sorted(want):
                self._load_entry(state_like, k, saved[k])
        except Exception as e:
            raise ValueError(
                f"checkpoint at step {step} in {self.dir} does not match "
                "the provided state_like structure (saved with a "
                f"different model/optimizer config?): {type(e).__name__}: "
                f"{e}") from e
        return state_like

    @staticmethod
    def _load_entry(state: dict, key: str, saved) -> None:
        cur = state[key]
        if isinstance(cur, torch.nn.Module):
            cur.load_state_dict(saved, strict=True)
        elif hasattr(cur, "load_state_dict"):
            cur.load_state_dict(saved)
        elif isinstance(cur, (list, tuple)):
            if len(cur) != len(saved):
                raise ValueError(f"{key}: {len(saved)} saved, "
                                 f"{len(cur)} in the state")
            for t, s in zip(cur, saved):
                if hasattr(t, "load_full"):  # a row shard of the table
                    t.load_full(s)
                    continue
                if t.shape != s.shape:
                    raise ValueError(f"{key}: shape {tuple(s.shape)} "
                                     f"saved, {tuple(t.shape)} in the state")
                t.copy_(s)
        else:
            state[key] = saved

    def close(self) -> None:
        """Saves are synchronous: nothing is left to finish."""
