"""CUDA graphs of the sampling loop and of the VAE decode.

Counterpart of the JAX package's compiled programs: SD-v1's
``SafeDiffusionPipeline._jitted_sample_fn`` (the whole scan, one program
per set of statics) and ``_jitted_sample`` (the decode as a second
program), and SD3's ``_jitted_sample_batch_fn``. A :class:`Program` is one
sampling loop and one decode at fixed statics, written against a dict of
input buffers. On ``cuda`` a pipeline's :class:`GraphSlot` captures the
whole loop (every step) into one ``torch.cuda.CUDAGraph`` and the decode
into a second, and replays both for every batch whose key matches. On the
CPU the same loop body runs eagerly on the same buffers
(:func:`_run_eager`, which ``chip_smoke.py`` also calls on the card to
hold a graph against it). No flag chooses between the two: the device
does, and on ``cuda`` a capture that fails raises.

The key: every static that the JAX package lists in ``static_argnames``
(steps, guidance, the repellency config, the window, FreeU; height and
width through the buffers' shapes), the scheduler, the modules and their
dtype and int8 state (the pipelines put these in ``Program.key``), the
switches the kernel wrappers read at call time (:data:`ENV_SWITCHES`), and
every buffer's name, shape and dtype (the batch, the text length, the
bank's shape).

Inputs: each per-request tensor -- initial latents, text embeddings and
their alternatives, SAFREE's mask, guidance scales, the bank, the noise,
the timestep table -- has a static buffer, and a batch copies its tensors
in before the replay. The noise is drawn before the replay, in the eager
loop's order (:func:`noise_slots`), so the graph and the eager loop see the
same numbers. A graph reads the modules' weights where they lie: an
in-place ``load_state_dict`` serves the next replay, while ``enable_int8``
(which replaces modules) changes the key.

Warm-up: before a capture the loop body runs one step eagerly on the
static buffers (the first step in the repellency window, so the hook runs
too) and the decode once, on a side stream, so that Triton (B5), cuBLAS,
cuDNN and cuFFT (FreeU) set themselves up outside the capture.

Outputs are cloned on the stream after each replay: a batch dispatched
before the previous one is fetched (the batcher's two-phase mode) would
otherwise overwrite it. A slot keeps one graph; a new key releases the old
graph and its memory pool before capturing.

Launch counters (``ops.COUNTERS``): the counters' change over the warm-up
and the capture is taken out again, and each replay adds the change that
its capture recorded, so a batch counts the kernels its replay launched.

Under a data mesh (``enable_data_mesh``) a pipeline keeps one GraphSlot a
mesh slot: :func:`shard_buffers` cuts the batch's buffers into each slot's
rows, each slot captures and replays its rows' loop and decode on its own
device (under ``parallel.mesh.on_slot``, with a capture stream of that
device), and :func:`run_slots` gathers the rows back in order. A bank
sharded over slots of more than one device runs eagerly
(``Program.graphable``): one device's graph cannot hold another's work.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import ops
from ..parallel.mesh import on_slot, split_rows

# the switches the kernel wrappers and modules read at each call
ENV_SWITCHES = ("SDT_FLASH2_LAYOUT", "SDT_ATTN_REPACK", "SDT_FUSED_GN",
                "SDT_UP_FORM", "SDT_INT8_ATTN", "SDT_FAST_SILU",
                "SDT_FAST_GELU", "SDT_GN_STATS_MIN")


def weights_version(*modules) -> int:
    """The sum of the modules' parameter version counters: any in-place
    change of a weight (``load_lora``, ``load_unet_state_dict``, an
    optimizer step) raises it, so a program keyed on it captures anew and
    a weight packed at capture (B3's ``cached_pack``) is not replayed
    stale."""
    return sum(p._version for m in modules for p in m.parameters())


def env_key() -> tuple:
    return tuple(os.environ.get(name) for name in ENV_SWITCHES)


def noise_slots(in_window: Sequence[bool], step_noise: bool
                ) -> dict[tuple[int, int], int]:
    """(step, salt) -> row of the noise buffer, in the eager loop's order
    of draws: step i's renoise (salt 1, inside the repellency window only),
    then its step noise (salt 2, where the scheduler takes one)."""
    slots: dict[tuple[int, int], int] = {}
    for i, inside in enumerate(in_window):
        if inside:
            slots[i, 1] = len(slots)
        if step_noise:
            slots[i, 2] = len(slots)
    return slots


def draw_noise(draw: Callable[[], torch.Tensor], n: int,
               like: torch.Tensor) -> torch.Tensor:
    """``n`` successive ``draw()``s stacked into [n, *like.shape]."""
    if n == 0:
        return like.new_empty((0, *like.shape))
    return torch.stack([draw() for _ in range(n)])


def warm_step(in_window: Sequence[bool]) -> int:
    """The step the warm-up runs: the first inside the window, else 0."""
    return next((i for i, inside in enumerate(in_window) if inside), 0)


@dataclasses.dataclass(frozen=True)
class Program:
    """One loop and one decode at fixed statics. ``loop(bufs, steps=None)
    -> (latents, applied)`` and ``decode(latents) -> image`` read nothing
    per request but ``bufs``; ``timesteps`` (host) name the steps in
    logs."""

    key: tuple
    loop: Callable
    decode: Callable[[torch.Tensor], torch.Tensor]
    warm_step: int
    timesteps: np.ndarray
    graphable: bool = True


# the batch dim of each per-request buffer (the rest are replicated)
BATCH_DIMS = {"latents": 0, "gs": 0, "noise": 1, "text": 1, "alt": 1,
              "use_alt": 1, "embeds": 1, "pooled": 1}


def bank_buffers(refs) -> dict:
    """The bank's buffers: "refs", or one "refs.<k>" a shard."""
    if isinstance(refs, (list, tuple)):
        return {f"refs.{k}": r for k, r in enumerate(refs)}
    return {"refs": refs}


def bank_from(bufs: dict):
    """The bank (a tensor, its shards, or None) from its buffers."""
    if "refs.0" in bufs:
        return [bufs[f"refs.{k}"] for k in range(
            sum(name.startswith("refs.") for name in bufs))]
    return bufs.get("refs")


def shard_buffers(bufs: dict, devices: Sequence[torch.device]) -> list:
    """One buffer dict a slot: the batched buffers cut into the slots' rows
    (``BATCH_DIMS``), the others copied; each on its slot's device."""
    out: list = [{} for _ in devices]
    for name, t in bufs.items():
        dim = BATCH_DIMS.get(name)
        pieces = (split_rows(t, len(devices), dim) if dim is not None
                  else [t] * len(devices))
        for i, dev in enumerate(devices):
            out[i][name] = pieces[i].to(dev)
    return out


def run_slots(slots: Sequence["GraphSlot"], program: Program,
              slot_bufs: Sequence[dict], home: torch.device,
              mark: Callable[[str], None] = lambda name: None):
    """(latents, applied, image) of a batch whose rows are split over
    slots: each slot's GraphSlot runs its rows (marks ``loop@i``,
    ``decode@i``, ``capture@i``), the rows gathered on ``home``."""
    res = [slot.run(program, b, lambda name, i=i: mark(f"{name}@{i}"))
           for i, (slot, b) in enumerate(zip(slots, slot_bufs))]
    return (torch.cat([r[0].to(home) for r in res]),
            torch.cat([r[1].to(home) for r in res], dim=1),
            torch.cat([r[2].to(home) for r in res]))


def _run_eager(program: Program, bufs: dict):
    """The loop and the decode, eagerly on ``bufs``: (latents, applied,
    image)."""
    with torch.no_grad():
        latents, applied = program.loop(bufs)
        return latents, applied, program.decode(latents)


def _buffers_key(bufs: dict) -> tuple:
    return tuple((name, tuple(t.shape), t.dtype, str(t.device))
                 for name, t in sorted(bufs.items()))


def _diff(a: dict, b: dict) -> dict:
    return {name: a[name] - b[name] for name in a}


class _Captured:
    """The loop's and the decode's graphs of one key, their static input
    buffers and their static outputs."""

    def __init__(self, key: tuple, program: Program, bufs: dict):
        self.key = key
        device = bufs["latents"].device
        self.static = {name: t.clone() for name, t in bufs.items()}
        before = ops.launch_counts()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            latents, _ = program.loop(self.static,
                                      steps=(program.warm_step,))
            program.decode(latents)
        torch.cuda.current_stream(device).wait_stream(side)
        del latents
        warm = ops.launch_counts()
        # a capture stream of this device: torch.cuda.graph's default is
        # one stream for the process, on the device current at first use
        capture = torch.cuda.Stream(device)
        self.loop_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.loop_graph, stream=capture):
            self.latents, self.applied = program.loop(self.static)
        looped = ops.launch_counts()
        self.decode_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.decode_graph, stream=capture):
            self.image = program.decode(self.latents)
        done = ops.launch_counts()
        self.loop_launches = _diff(looped, warm)
        self.decode_launches = _diff(done, looped)
        ops.add_launch_counts(_diff(before, done))

    def replay_loop(self, bufs: dict):
        for name, t in bufs.items():
            self.static[name].copy_(t)
        self.loop_graph.replay()
        ops.add_launch_counts(self.loop_launches)
        return self.latents.clone(), self.applied.clone()

    def replay_decode(self) -> torch.Tensor:
        self.decode_graph.replay()
        ops.add_launch_counts(self.decode_launches)
        return self.image.clone()


class GraphSlot:
    """A pipeline's last captured program (a cache of one)."""

    def __init__(self):
        self._captured: Optional[_Captured] = None

    def release(self) -> None:
        """Drop the graphs, their memory pools and static buffers."""
        if self._captured is not None:
            self._captured = None
            torch.cuda.empty_cache()

    def run(self, program: Program, bufs: dict,
            mark: Callable[[str], None] = lambda name: None):
        """(latents, applied, image) of one batch: on ``cuda`` through the
        graphs of ``program`` (captured first when the key is new;
        ``mark("capture")`` after it), elsewhere (or where the program is
        not ``graphable``) eagerly on ``bufs``;
        ``mark("loop")`` and ``mark("decode")`` after each stage. Runs
        with the buffers' device current (``on_slot``)."""
        with torch.no_grad(), on_slot(bufs["latents"].device):
            if bufs["latents"].device.type != "cuda" or \
                    not program.graphable:
                latents, applied = program.loop(bufs)
                mark("loop")
                image = program.decode(latents)
                mark("decode")
                return latents, applied, image
            key = (program.key, env_key(), _buffers_key(bufs))
            if self._captured is None or self._captured.key != key:
                self.release()
                self._captured = _Captured(key, program, bufs)
                mark("capture")
            latents, applied = self._captured.replay_loop(bufs)
            mark("loop")
            image = self._captured.replay_decode()
            mark("decode")
            return latents, applied, image
