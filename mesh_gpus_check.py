"""The parallel layer with its slots on GPUs of their own.

``chip_smoke.py`` runs phase 11 on slots that all lie on cuda:0. This
script runs the same checks with the slots spread over the visible GPUs
(slot i on cuda:(i mod N)), so that every slot's kernels, CUDA graphs and
module copies live on another device than the pipeline's:

  * sd14-mesh, sd14-bank-shard and unet-tp (``chip_smoke.phase_parallel_sd14``):
    a data mesh over cuda:0 and cuda:1 whose rows equal, bit for bit,
    ``generate_batch`` on each slot's sub-batch; the bank over 4 slots;
    the UNet's attention over 2 model slots;
  * the data mesh again with new seeds (the graphs replayed, not
    captured), and after an in-place change of the UNet's weights (the
    other GPUs' copies made again): each slot's rows equal to its
    sub-batch's;
  * sd3-parallel (``chip_smoke.phase_parallel_sd3``): SP, PP, TP and the
    bank of the run's own x0 over the slots;
  * the sixteen paths of ``safe_denoiser_tpu_torch.dryrun``.

Usage: ``python3 mesh_gpus_check.py [--gpus N]`` (default: every visible
GPU; ``--gpus 1`` lays every slot on cuda:0, as the smoke does). Exits
non-zero on any miss; the last line is ``{"ok": true, "gpus": N, ...}``.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

import chip_smoke as smoke


def mesh_rows_follow(pipe, mesh_pipe, kw, seeds, what: str) -> torch.Tensor:
    """A 4-row 50-step batch of ``seeds`` on ``mesh_pipe`` (a data mesh of
    2 slots), each slot's rows held bit for bit against ``pipe``'s
    ``dispatch_batch`` of its 2-row sub-batch. Returns the latents."""
    import numpy as np

    pending = mesh_pipe.dispatch_batch(smoke.PROMPTS, seeds=seeds,
                                       num_inference_steps=50, **kw)
    rows = pending.fetch()
    for lo in (0, 2):
        sub = pipe.dispatch_batch(smoke.PROMPTS[lo:lo + 2],
                                  seeds=seeds[lo:lo + 2],
                                  num_inference_steps=50,
                                  **{**kw, "guidance_scales": [7.5] * 2})
        images = sub.fetch()
        for k in range(2):
            if not (np.array_equal(rows[lo + k], images[k]) and torch.equal(
                    pending.latents[lo + k].to(sub.latents.device),
                    sub.latents[k])):
                smoke.fail(f"sd14-mesh {what}: row {lo + k} differs from "
                           "generate_batch on its slot's sub-batch")
    print(f"sd14-mesh {what}: 4 rows equal bit for bit (latents and PNG) to "
          f"generate_batch on each slot's 2-row sub-batch; stages "
          f"{json.dumps({k: round(v, 2) for k, v in pending.stage_ms.items()})}")
    return pending.latents


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, default=None,
                    help="GPUs to lay the slots over (default: all visible)")
    args = ap.parse_args()
    from safe_denoiser_tpu_torch.dryrun import dryrun_multichip
    from safe_denoiser_tpu_torch.parallel import make_mesh

    smoke.phase_env()
    n = len(make_mesh(args.gpus).devices.flat)
    devices = [torch.device("cuda", i % n) for i in range(max(n, 4))]
    print(f"{n} GPU(s): {[torch.cuda.get_device_name(i) for i in range(n)]}"
          f"; slots {[str(d) for d in devices]}")
    smoke.phase_build()
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as vocab_dir:
        smoke.write_tiny_vocab(vocab_dir)
        pipe = smoke.build_random_pipeline(dev, vocab_dir)
    kw = smoke.sd14_kw(dev)
    pipe.generate_batch(smoke.PROMPTS, seeds=[0, 1, 2, 3],
                        num_inference_steps=2, **kw)            # warm-up
    gate = smoke.phase_gate_open(pipe)
    _, mesh_pipe, _ = smoke.phase_parallel_sd14(pipe, kw, gate, devices)
    del gate
    seeds = [10, 11, 12, 13]
    before = mesh_rows_follow(pipe, mesh_pipe, kw, seeds, "new seeds")
    with torch.no_grad():
        pipe.unet.conv_in.weight.mul_(1.25)
    after = mesh_rows_follow(pipe, mesh_pipe, kw, seeds,
                             "after a weight change")
    if torch.equal(before, after):
        smoke.fail("sd14-mesh: the weight change did not change the rows")
    del mesh_pipe, pipe
    torch.cuda.empty_cache()
    smoke.phase_parallel_sd3(devices)
    t1 = time.perf_counter()
    dryrun_multichip(devices=devices)
    print(f"dryrun_multichip over {smoke.slots_text(devices)}: "
          f"{time.perf_counter() - t1:.1f} s")
    print(f"mesh check: {time.perf_counter() - t0:.1f} s after the build")
    print(json.dumps({"ok": True, "gpus": n,
                      "slots": [str(d) for d in devices]}))


if __name__ == "__main__":
    main()
