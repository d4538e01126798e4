"""Training checkpoint and resume: (trained tensors, optimizer state, step,
generator state, metadata) snapshots.

Counterpart of ``safe_denoiser_tpu/training/checkpoint.py``, in the port's
own format: one ``torch.save`` file, written atomically (tmp +
``os.replace``) so a preemption mid-write never corrupts the previous
snapshot. It cannot read the JAX package's msgpack snapshots (optax's
state tree has no torch counterpart), and the JAX package cannot read its.

Restore takes the live trained tensors and optimizer as templates: values
are copied into them in place, so the optimizer keeps pointing at the same
tensors, and a leaf whose shape differs from the template is refused with
the JAX package's message. With the generator's state restored, a resumed
run is bit-identical to an uninterrupted one.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .esd import _flat_tensors


def _trained(params) -> list:
    return [(n, p) for n, p in _flat_tensors(params) if p.requires_grad]


def save_train_state(path: str, params, opt: torch.optim.Optimizer,
                     step: int, generator: Optional[torch.Generator] = None,
                     metadata: Optional[dict] = None) -> None:
    """Atomically snapshot a training loop's restartable state: of
    ``params`` ({name: tensor} or a LoRA adapter) the trained tensors, those
    that require grad (``make_optimizer`` set them); the frozen rest is
    the checkpoint the run started from."""
    state = {
        "params": {n: p.detach().cpu() for n, p in _trained(params)},
        "opt_state": opt.state_dict(),
        "step": int(step),
        "rng": None if generator is None else generator.get_state(),
        "metadata": dict(metadata or {}),
    }
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str, params, opt: torch.optim.Optimizer,
                        generator: Optional[torch.Generator] = None):
    """-> (params, opt, step, generator, metadata), the snapshot's values
    copied into the live ``params`` and ``opt`` (and ``generator``'s state
    set where the snapshot has one)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    live = dict(_trained(params))
    saved = state["params"]
    for name, tmpl in live.items():
        got = tuple(saved[name].shape) if name in saved else None
        if got != tuple(tmpl.shape):
            raise ValueError(
                f"checkpoint {path} params leaf {name} has shape {got} but "
                f"the live template expects {tuple(tmpl.shape)} — the run "
                "was restarted with different hyperparameters (e.g. "
                "--lora_rank) than the snapshot was written with")
    with torch.no_grad():
        for name, tmpl in live.items():
            tmpl.copy_(saved[name])
    opt.load_state_dict(state["opt_state"])
    if generator is not None and state["rng"] is not None:
        generator.set_state(state["rng"])
    return params, opt, int(state["step"]), generator, state["metadata"]
