"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # every phase, needs one CUDA GPU
    python3 chip_smoke.py --profile  # every phase, plus profiled batches
    python3 chip_smoke.py --parent DIR  # every phase, plus phase 3b

Phases, each of which ends the run with a non-zero exit code on failure:
  1. environment: torch/CUDA versions, the card's name and power limit, the
     TF32 switches (turned off for the f32 checks);
  2. build: nvcc builds the CUDA kernels from csrc/ (Triton compiles B5,
     the GroupNorm statistics kernel, at its first launch);
  3. kernel checks: ptxas' registers, spills and static shared memory of
     every kernel in csrc/ (and the dynamic shared memory of every template
     of the attention core that B1, B9 and B10 share, attention_hopper.cuh,
     and of its int8 form, B8's, and of the three forms of the conv core
     that B4, B3 and B7 share, conv_hopper.cuh: the wgmma kernels; B2's and
     B6's cluster kernels take theirs from each shape's plan, printed on
     their rows with the cluster sizes);
     then each kernel at the main path's shapes (and B4/B5 also at the
     runner's bank-encode shapes; B2 also at CoPro's 3000-row bank and, in
     its raw form, at phase 11's bank shards with a PAD row; B9/B10
     also in f32; B7 beside B3) against
     its plain PyTorch version, with its device time and a library call's
     where one exists (``device_ms``: calls captured into a CUDA graph and
     replayed), the bound the card could reach, and the wrapper-paced
     times of the kernel, the library call and the plain version
     (``cuda_ms``: events around Python calls); then the backward kernels
     (B1b, B5b, B3b-dx, B3b-dw) at the training slice's shapes against
     their plain backward in f32, with the autograd backward of the
     PyTorch call as the library time (for B1b also aten's flash backward
     alone as the library device time), B1's forward that keeps the
     logsumexp for B1b (its output the no-grad one bit for bit, the
     logsumexp within LSE_ATOL of the plain one), and two calls of B1b
     and B3b-dw equal bit for bit;
  3b. with --parent DIR (the root of an earlier checkout, unpacked with
     ``git archive``): its attention.cu, attention_nt.cu, attention_bshd.cu,
     conv3x3.cu, conv3x3_up.cu, attention_i8.cu, conv3x3_up_interleave.cu,
     rbf.cu and attention_bwd.cu built with the same flags, and its
     ops/group_norm.py loaded by path (B6 in Triton before this checkout's
     CUDA kernel); B1, B1b, B9, B10, B4, B3, B8, B7, B2 and B6 of both
     timed in turns (parent, this, this, parent; device times) at the main
     path's shapes (B1b, B8, B7, B2 and B6 at phase 3's);
  4. main path: the tiny f32 slice on cuda against the CPU, at 8^2 latents
     and at 32^2 (S = 1024) under each attention layout (bhsd, nt, nt with
     the head repacks, bshd: SDT_FLASH2_LAYOUT / SDT_ATTN_REPACK), then
     SafeDiffusionPipeline on cuda at full SD-v1.4 width with seeded random
     weights -- 4 prompts, 512x512, 50 DDPM steps, CFG 7.5, kernel_fast
     repellency against a [515,4,64,64] bank in the window [1000, 780], VAE
     decode -- and the launch count of every kernel; every main path
     checks that the attention wrappers copied no q/k/v for their tensor
     maps. The pipelines run the loop and the decode from CUDA graphs
     (pipeline/graph.py; launches are counted per replay): the graph
     check holds sd14-main's graphed batch against the eager loop body on
     the same buffers, latents, rep_applied and image bit for bit, and
     prints both loop times;
  5. gate check: the same pipeline for 5 steps with a bank built from the
     run's own x0, so the beta gate opens at full width and B2's score
     must reach the latents;
  6. runner: ``safe_denoiser_tpu_torch.runners.nudity.main`` on cuda at
     full SD-v1.4 width -- phase 4's random weights written as an HF-layout
     safetensors checkpoint, 32 random 512^2 PNG bank images VAE-encoded
     through the fused conv and beta-calibrated, 4 CSV prompts x 50 steps
     with std_rep, a small NudeNet-shaped ONNX classifier as the gate --
     its output tree and the launch count of every kernel;
  6e. artist and SPELL: ``runners.artist ann_graham`` (2 samples) and
     ``munch`` (1) on phase 6's checkpoint with configs/ann_graham's and
     configs/munch's kernel_fast against 16 random 512^2 bank PNGs encoded
     through B4; ``runners.nudity`` under configs/sparse_repellency/
     spell.yaml's parameters against a cached [515,4,64,64] bank, 4 cases
     (B2 never runs); the SPELL force at full width against a bank of the
     run's own x0, which must move the latents; the euclidean (B2), kernel
     and lsh processors' conditioning on cuda against the CPU;
  6f. CoPro: ``runners.copro`` with the Q16 gate on a random full ViT-L/14
     tower (303M parameters, an HF-named safetensors file), 4 CSV prompts
     x 50 steps, kernel_fast without the beta gate against a cached
     3000-row bank (B2 at M = 3000); the tower's embedding on cuda against
     the CPU's, and its time per image;
  6g. COCO (BASELINE #2): ``runners.coco30k`` on phase 6's checkpoint with
     the in-loop CLIPScore on a random full CLIP ViT-B/32 (an HF-named
     sharded directory, the tiny vocab as its tokenizer): 4 CSV prompts x
     50 steps at batch 1 with CFG 7.5, vanilla; the same 4 with
     --batch_size 4 (``dispatch_batch``); 2 under configs/coco/
     safe_denoiser.yaml's kernel_fast (beta calibrated on the GPU) against
     a cached random [515,4,64,64] bank; output trees, CLIP lines, launches;
  6h. offline evaluators on 6g's and 6f's outputs: ``runners.evaluate
     coco30k_fid_clip --allow_random_init`` (FID, KID, log-KID against 8
     random reference PNGs, then CLIPScore), ``runners.evaluate
     copro_aes_clip`` (6f's ViT-L/14, a random AES MLP), the image-image
     similarity on a random full OpenCLIP ViT-H-14 vision tower; no kernel
     launched; the Inception on cuda against the CPU; each tower's time
     per image and the host seconds of FID's 2048^2 sqrtm;
  6b. DDIM: the 10-step DDIM configuration (BASELINE.md #1) at full SD-v1.4
     width on phase 4's modules -- 4 prompts, 512x512, CFG 7.5, kernel_fast
     in [1000, 780] -- under bhsd, nt with the repacks and bshd; stage
     times and launch counts;
  6c. the same DDIM configuration under SDT_FUSED_GN=1 and
     SDT_UP_FORM=interleave: the UNet's GroupNorms on the fused GroupNorm
     kernel (B6) where the JAX gate admits them, the VAE decoder's
     upsamples on the interleaved upsample conv (B7); launches asserted
     exactly (B6 570, B5 60, B3 10, B7 3, B4 28, B1 100, B2 2);
  6d. SD-v1's text-side erasure at full width on phase 4's modules, 4
     prompts x 512^2 x 50 steps through dispatch_batch: sld_rep (SLD
     STRONG), safree_rep with SAFREE and its self-validation filter,
     std_rep with latent re-attention and the SafeGuard filters; finite
     images, stage times, launch counts, and the graph check of each
     (safree_rep's svf windows must differ between prompts). Phase 6's
     runner also runs --erase_id sld_rep on 2 cases under the two switches
     of 6c;
  7. SD3: SafeDiffusion3Pipeline on cuda at full SD3-medium width and
     depth with seeded random weights (CLIP-L, CLIP-bigG, T5-XXL, the
     24-block MMDiT, the 16-channel VAE) -- 1 prompt, 1024x1024, 50
     flow-match steps, CFG 2.5, kernel_fast renoising repellency against a
     [16,16,128,128] bank in [1000, 780] -- three times: bf16 (attention
     kernel), bf16 under nt with the repacks (B9, B11, B12), and with
     enable_int8() and SDT_INT8_ATTN=1 (W8A8 MMDiT, int8-QK^T attention
     kernel); stage times, images and launch counts, the graph check of
     the bf16 run; then the bf16 latents decoded again under
     SDT_UP_FORM=interleave (B7 3, B3 0);
  8. SD3 runner: ``safe_denoiser_tpu_torch.runners.sdv3.main_nudity`` with
     --int8 and SDT_INT8_ATTN=1 on an HF-layout checkpoint at the published
     widths (depth cut: MMDiT 6 of 24 blocks, T5 2 of 24, bigG 4 of 32), 16
     random 1024^2 bank PNGs, SAFREE on, 2 CSV prompts x 50 steps; its
     output tree and launch counts;
  8b. SD3 COCO: ``runners.sdv3 coco30k`` in bf16 on that checkpoint under
     configs/coco/safe_denoiser_sdv3.yaml against a cached random
     [16,16,128,128] bank, 2 CSV prompts x 50 steps at 1024^2; its output
     tree and launch counts (B1 at SD3's shape, B2, the decode's kernels);
  9. serving: ``runners.serve`` on phase 6's checkpoint with
     configs/nudity/safe_denoiser.yaml's kernel_fast against a cached
     random [515,4,64,64] bank (std_rep), --batch_size 4, in a thread on
     an ephemeral port: its warm-up batch captures the graphs, /healthz,
     then 6 concurrent /generate requests (a full batch and a padded one),
     each PNG equal bit for bit to ``generate_batch`` on phase 4's
     pipeline over the batch the batcher formed; ms a request and images/s
     under load; --export_aot, then --aot_bundle with the same flags (its
     batch equal to the live one) and refusals of other steps and of
     another task YAML; after phase 8b, ``--sd3`` on phase 8's checkpoint
     with 2 requests at 1024^2. Launch counts of every kernel.
  10. training (after phase 9, on phase 6's checkpoint): ``runners.
     train_esd`` at full SD-v1.4 width, batch 1, 512^2 -- noxattn for 3
     iterations with a snapshot at 2, the same run resumed from it (equal
     bit for bit), a LoRA run (rank 4, xattn, the adapter saved) --
     and ``runners.edit_concepts`` (RECE); the losses, the changed
     subsets, the export through ``load_unet_state_dict`` and
     ``load_lora`` against the in-memory merge, the B1/B1b, B5/B5b and
     B3/B3b launches per iteration, an iteration's device ms by part, the
     peak memory, and one ESD loss's gradient on the card (bf16, the
     kernels) against the CPU (f32, the plain versions) per parameter
     group (``phase_grad_check``);
  10b. after phase 9's SD3 server: SD3 flow matching under LoRA on phase
     8's checkpoint (MMDiT 1536 wide, 6 blocks), 1024^2, batch 1, 2 steps
     (B1/B1b at [1,4429,24,64]); finite losses, the adapter moved.
  11. parallel (after phase 5, on phase 4's modules; slots repeat cuda:0,
     so it measures the layer's overhead, not scaling): sd14-mesh, phase
     4's batch on a data mesh of 2 slots, each slot's rows equal bit for
     bit to generate_batch on its 2-row sub-batch; the 515-row bank over
     4 slots on a 2-row batch (B2 4 x 11 launches; latents equal to the
     replicated bank's while the gate stays closed) and phase 5's gate
     batches on it (the sharded score moves the latents, within
     PAR_REL_BOUND of the replicated run); unet-tp, one UNet forward over
     2 model slots (B1 at [8,4096,4,40]); sd3-parallel at SD3-medium's
     widths, 6 blocks, 5 steps: SP over 2 seq slots, PP over 4 pipe slots
     in 2 microbatches, the bank over 4 slots, one forward under TP over 2
     model slots (B1 at [2,4429,12,64]), each against the unsharded run;
     serve-mesh, the batcher on the data-mesh pipeline (each PNG equal to
     its slot's generate_batch), and ``runners.serve --mesh 2`` raising on
     one GPU before it writes anything; the 16 paths of
     ``dryrun.dryrun_multichip`` over 8 cuda:0 slots.
  12. the tail (after phase 6, on its checkpoint, gate and output): the
     seed-sweep classifier runner (``runners.classify``, 4 seeds x 50
     steps, each PNG equal to ``dispatch(seed)``); the negative-bank data
     loop (``tools.data_prep.generate_negative_bank`` over 4 prompts, the
     filed PNGs encoded by the runners' bank loader into a .pt bank, a
     kernel_fast batch against it with the beta gate open moving the
     latents); phase 6's run in two shards whose merged detect_dict.json
     (``tools.logs``) equals phase 6's, and ``parse_log`` on its logs;
     ``utils.profiling.trace`` around a graphed sd14-main batch (B1, B4,
     the annotated region and the recorder's ``sdt.graph.replay_loop`` of
     the batch in the trace); the model FLOPs of an sd14-main and an
     sd3-main image (``utils.flops`` on ``meta``) and the MFU of this
     run's sd14-main batch; the native BPE engine's ids against the
     Python path's; the NudeNet ``Detector`` and ``censor`` on a toy
     detector graph.
The last line of standard output is the result, {"ok": true, "device": ...};
the line before it lists the kernels as JSON.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 without
# tensor cores, device memory bandwidth
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# launches per batch on the main path, derived from the JAX package's gates:
# attention: 10 self-attentions with S >= 512 per UNet step x 50 steps;
# rbf: 11 in-window steps (t = 981 ... 781); conv3x3_up: 1 UNet upsample
# (32->64, 640 ch) x 50 + 3 VAE upsamples; conv3x3: 14 VAE-decoder resnets
# (2 mid + 4 x 3 up) x 2 convs; gn_stats: 3 up_blocks[3] norm1 per step x
# 50 + 30 VAE-decoder norms
EXPECTED_LAUNCHES = {"attention": 500, "rbf": 11, "conv3x3_up": 53,
                     "conv3x3": 28, "gn_stats": 180, "attention_i8": 0,
                     "attention_nt": 0, "attention_bshd": 0,
                     "repack_to_heads": 0, "repack_from_heads": 0,
                     "conv3x3_up_interleave": 0, "gn_fused": 0}
# phase 5's batches: 5 DDPM steps, only t = 801 in [1000, 780]
GATE_STEPS = 5
# SD-v1.4's image side on the main path
SD14_SIDE = 512
# the decode measured with cuDNN resnet convs before the fused conv (PERF.md)
DECODE_MS_CUDNN = "51.07-51.99"

# the runner phase: 4 cases of batch 1 x 50 steps (std_rep: window
# [1000, 800], 10 in-window steps t = 981 ... 801), a 32-image bank encoded
# in 2 chunks of n_embed 16 (launches: ``runner_launches``)
RUNNER_CASES, RUNNER_BANK, RUNNER_N_EMBED = 4, 32, 16
# the runner's second run: sld_rep (SLD STRONG's 3-branch batch, window
# [1000, 780]) on 2 of the CSV's cases under FUSED_SWITCHES
RUNNER_SLD_CASES = 2
# 6e: the artist runs' samples (ann_graham; munch takes 1) and bank
# images, the SPELL run's cases, the SPELL force check's copies of each x0
ARTIST_SAMPLES, ARTIST_BANK = 2, 16
SPELL_CASES, SPELL_COPIES = 4, 8
# 6f: the CoPro run's cases and its bank (BASELINE #4's 3k-image bank)
COPRO_CASES, COPRO_BANK = 4, 3000
# 6g: BASELINE #2's COCO cases (each coco_id is its case number, since the
# offline CLIPScore keys an image by its file's stem), the batched run's
# batch, the safe run's cases (against a bank of sd14-main's 515 rows)
COCO_IDS = (391895, 522418, 184613, 318219)
COCO_BATCH, COCO_SAFE_CASES = 4, 2
# 6h: the reference images of FID/KID and the image-image similarity
COCO_REFS = 8

# SD3 (bench.py's sd3 legs: SD3-medium, 1 prompt with CFG, 1024^2, 50
# flow-match steps, CFG 2.5, kernel_fast against a 16-latent bank)
SD3_PROMPT = "a photo of a cat on a sofa"
SD3_STEPS, SD3_SIDE, SD3_BANK = 50, 1024, 16
# the runner phase: its checkpoint's depth cuts, cases and bank
SD3_RUNNER_LAYERS = {"mmdit": 6, "t5": 2, "clip_g": 4}
SD3_RUNNER_CASES, SD3_RUNNER_N_EMBED = 2, 8
# 8b: the SD3 COCO run's cases on the runner's checkpoint
SD3_COCO_CASES = 2
# 9: the server's batch size and concurrent requests (a full batch and a
# padded one), its batching deadline; the SD3 server's requests
SERVE_BATCH, SERVE_REQUESTS, SERVE_DELAY_MS = 4, 6, 2000
SD3_SERVE_REQUESTS = 2

# B6's phase-3 shapes: the UNet's admitted GroupNorms with 32 groups (the
# largest, a 1280-wide one, the 2560-wide one at S = 64) in bf16, then the
# first in f32
GN_SHAPES = ((8, 4096, 320, torch.bfloat16), (8, 1024, 1280, torch.bfloat16),
             (8, 64, 2560, torch.bfloat16), (8, 4096, 320, torch.float32))

# B8's max|d| bound at each phase-3 shape, on the inputs b8_errors draws
# for it: above the sound kernel's readings over nine seeds and below B1's
# on the same inputs (a B8 that skipped the quantization), so such a
# kernel fails at every shape, the SD3 joint attention first; phase 3
# fails if B1's reading falls under the bound. Readings in PERF.md.
B8_ATOL = {(2, 4429, 24, 64): 2.5e-3, (8, 4096, 8, 40): 3.2e-3,
           (8, 1024, 8, 80): 4e-3, (2, 600, 8, 40): 1.2e-3}


# B1's f32 GPU test bound (tests/test_torch_port_cuda.py): |d| <= F32_TOL +
# F32_TOL * |plain|
F32_TOL = 2e-5

# the self-attention layouts (the JAX package's SDT_FLASH2_LAYOUT and
# SDT_ATTN_REPACK switches) and the attention kernels' counters
LAYOUTS = {"bhsd": {}, "nt": {"SDT_FLASH2_LAYOUT": "nt"},
           "nt+repack": {"SDT_FLASH2_LAYOUT": "nt", "SDT_ATTN_REPACK": "1"},
           "bshd": {"SDT_FLASH2_LAYOUT": "bshd"}}
ATTN_KERNELS = ("attention", "attention_i8", "attention_nt",
                "attention_bshd", "repack_to_heads", "repack_from_heads")

# the 10-step DDIM configuration (BASELINE.md #1, bench.py's
# sd14_10step_ddim): 4 prompts, 512^2, CFG 7.5, kernel_fast in [1000, 780]
DDIM_STEPS = 10
DDIM_LAYOUTS = ("bhsd", "nt+repack", "bshd")
# the two switches that route to B6 and B7 (off by default, as in the JAX
# package)
FUSED_SWITCHES = {"SDT_FUSED_GN": "1", "SDT_UP_FORM": "interleave"}
# phase 6d: the SD-v1 erasure methods at full width, each (erase id,
# safree_dict, SLD level, FreeU hyperparameters b1, b2, s1, s2 or None);
# the FreeU set is the runner's default --freeu_hyp
ERASURE_RUNS = {
    "sld_rep": ("sld_rep", {}, "STRONG", None),
    "safree_rep+svf": ("safree_rep", {"safree": True, "svf": True}, None,
                       None),
    "std_rep+lra": ("std_rep", {"lra": True}, None, (1.0, 1.0, 0.9, 0.2)),
}


def attention_launches(layout: str, n: int, int8: bool = False) -> dict:
    """Each attention kernel's launches for n self-attentions of the
    kernels' shapes under ``layout`` (bshd: S % 512 == 0), from the JAX
    package's dispatch: bhsd takes B1 (B8 with ``int8``), nt B9, nt with
    the repack three B11 and one B12 around B9, bshd B10."""
    counts = dict.fromkeys(ATTN_KERNELS, 0)
    if layout == "bhsd":
        counts["attention_i8" if int8 else "attention"] = n
    elif layout == "bshd":
        counts["attention_bshd"] = n
    else:
        counts["attention_nt"] = n
        if layout == "nt+repack":
            counts["repack_to_heads"] = 3 * n
            counts["repack_from_heads"] = n
    return counts


def layout_env(layout: str):
    """The attention layout switches of ``layout`` for a run."""
    return switches(LAYOUTS[layout], ("SDT_FLASH2_LAYOUT", "SDT_ATTN_REPACK"))


@contextlib.contextmanager
def switches(env: dict, names=()):
    """Set the switches of ``env`` (and clear those in ``names``) for a run,
    and restore them after it, so later phases see the defaults."""
    saved = {k: os.environ.pop(k, None) for k in (*names, *env)}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


@contextlib.contextmanager
def count_self_attention():
    """Count the self-attentions of the kernels' shapes (D <= 256; a wider
    head takes the plain q-chunked path) that run inside the block."""
    from safe_denoiser_tpu_torch.ops import attention

    inner, calls = attention.self_attention, [0]

    def counted(q, k, v, sm_scale):
        calls[0] += q.shape[3] <= 256
        return inner(q, k, v, sm_scale)

    attention.self_attention = counted
    try:
        yield calls
    finally:
        attention.self_attention = inner


def check_launches(counts: dict, want: dict, what: str) -> None:
    from safe_denoiser_tpu_torch.ops import attention

    print(f"{what} launches: {json.dumps(counts)} expected "
          f"{json.dumps(want)}")
    # B1's, B9's and B10's tensor maps take every main path's q/k/v
    # without a copy
    if attention.staging_copies:
        fail(f"{what}: the attention wrappers copied q/k/v "
             f"{attention.staging_copies} times")
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{what}: kernel {name} launched {counts[name]} times, "
                 f"expected {n}")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Events around ``reps`` Python calls of ``fn``: where a call's host
    work (checks, allocation, the launch) outlasts its kernels, this is the
    host's pace, not the device's (wrapper-paced; see ``device_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: after a warm-up (which builds and
    compiles what the call needs), ``reps`` calls are captured into one
    CUDA graph and its replay is timed with CUDA events, so no host work
    sits between the launches. The graph (and the outputs in its private
    pool) is freed before returning. A capture that fails ends the run."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()                      # first replay uploads the graph
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
    except Exception as e:  # any failure of capture or replay ends the run
        fail(f"device_ms: CUDA graph capture or replay failed: "
             f"{type(e).__name__}: {e}")
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    if not (math.isfinite(ms) and ms > 0):
        fail(f"device_ms: no device time ({ms})")
    return ms


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_check(pipe, label: str, prompts, seeds, windows=None,
                **kw) -> None:
    """One batch through the pipeline's CUDA graphs (``_launch``) against
    the eager loop body and decode on the same buffers (``Program.loop`` /
    ``decode``: the same inputs and noise): latents, rep_applied and image
    must be equal bit for bit. ``windows``: SAFREE's window of each prompt
    in steps, written into its mask buffer in place of the one the text
    preparation gave. Prints the graphed and the eager loop and decode
    times (CUDA events) and, where SAFREE's mask is an input, its steps per
    prompt."""
    program, bufs = pipe._prepare_batch(prompts, seeds, **kw)
    if windows is not None:
        steps = torch.arange(bufs["use_alt"].shape[0], device=pipe.device)
        bufs["use_alt"] = steps[:, None] < torch.tensor(windows,
                                                        device=pipe.device)
    pending = pipe._launch(program, bufs)
    pending.fetch()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.no_grad():
        ev[0].record()
        lat, applied = program.loop(bufs)
        ev[1].record()
        image = program.decode(lat)
        ev[2].record()
    torch.cuda.synchronize()
    st = pending.stage_ms
    same = {"latents": torch.equal(pending.latents, lat),
            "applied": torch.equal(pending.applied, applied),
            "image": torch.equal(pending.image, image)}
    times = {"graph_loop_ms": st["loop"], "graph_decode_ms": st["decode"],
             "eager_loop_ms": ev[0].elapsed_time(ev[1]),
             "eager_decode_ms": ev[1].elapsed_time(ev[2])}
    safree = ("" if "use_alt" not in bufs else
              f" safree steps per prompt {bufs['use_alt'].sum(0).tolist()}")
    print(f"graph check {label}: " + " ".join(
        f"{k}={v:.2f}" for k, v in times.items())
        + f" capture_ms={st.get('capture', 0.0):.2f} rep_applied_steps="
        f"{int(applied.any(1).sum())} equal={json.dumps(same)}{safree}")
    if not all(same.values()):
        d = (pending.latents.float() - lat.float()).abs().max().item()
        fail(f"graph check {label}: the graphed batch differs from the "
             f"eager loop on the same buffers ({same}; max|d| latents "
             f"{d:.3e})")


def vae_kernel_plan(cfg, b: int, h: int, w: int, part: str = "decoder"):
    """The port's kernel launches in one bf16 VAE decode of [b, C, h, w]
    latents (or encode of [b, 3, h, w] images), derived from its routing
    predicates over the module structure as the switches stand: a resnet
    takes the fused conv (B4) for both convs when ``conv3x3.supports``
    holds at both (its GroupNorms then give statistics only), else each
    conv that it takes; an upsample takes B3 (B7 under
    SDT_UP_FORM=interleave) where ``supports_up`` holds, else B4 on the
    upsampled input where that is supported; a GroupNorm that normalizes
    takes B6 where ``takes_fused_kernel`` holds, and otherwise, as the
    statistics-only ones, B5 where ``takes_stats_kernel`` holds. Returns
    (counts, shapes): shapes per kernel as (b, h, w, c) for the upsample
    convs, (b, h, w, ci, co, residual) for conv3x3 and (b, s, c) for the
    GroupNorm kernels."""
    from safe_denoiser_tpu_torch.ops import conv3x3 as c3
    from safe_denoiser_tpu_torch.ops import group_norm as gn

    up = ("conv3x3_up_interleave"
          if os.environ.get("SDT_UP_FORM", "planar") == "interleave"
          else "conv3x3_up")
    counts = {"conv3x3_up": 0, "conv3x3_up_interleave": 0, "conv3x3": 0,
              "gn_stats": 0, "gn_fused": 0}
    shapes = {k: [] for k in counts}
    groups = cfg.norm_num_groups

    def add(kind, shape):
        counts[kind] += 1
        if shape not in shapes[kind]:
            shapes[kind].append(shape)

    def norm(hh, ww, c, coefs_only=False):
        if not coefs_only and gn.takes_fused_kernel(hh * ww, c, groups):
            add("gn_fused", (b, hh * ww, c))
        elif gn.takes_stats_kernel(hh * ww, c):
            add("gn_stats", (b, hh * ww, c))

    def resnet(ci, co, hh, ww):
        fused = (c3.supports((b, hh, ww, ci), ci, co)
                 and c3.supports((b, hh, ww, co), co, co))
        norm(hh, ww, ci, fused)
        norm(hh, ww, co, fused)
        if fused or c3.supports((b, hh, ww, ci), ci, co):
            add("conv3x3", (b, hh, ww, ci, co, False))
        if fused or c3.supports((b, hh, ww, co), co, co):
            add("conv3x3", (b, hh, ww, co, co, fused))

    chans = list(cfg.block_out_channels)
    if part == "decoder":
        chans = chans[::-1]
        mid = (chans[0], h, w)
    else:
        ci = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                resnet(ci if j == 0 else ch, ch, h, w)
            ci = ch
            if i < len(chans) - 1:
                h, w = h // 2, w // 2
        mid = (chans[-1], h, w)
    c, mh, mw = mid
    resnet(c, c, mh, mw)
    norm(mh, mw, c)                    # the mid-block attention's norm
    resnet(c, c, mh, mw)
    if part == "decoder":
        ci = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block + 1):
                resnet(ci if j == 0 else ch, ch, h, w)
            ci = ch
            if i < len(chans) - 1:
                if c3.supports_up((b, h, w, ch), ch, ch):
                    add(up, (b, h, w, ch))
                elif c3.supports((b, 2 * h, 2 * w, ch), ch, ch):
                    add("conv3x3", (b, 2 * h, 2 * w, ch, ch, False))
                h, w = 2 * h, 2 * w
    norm(h, w, chans[-1])              # conv_norm_out
    return counts, shapes


def unet_norm_shapes(cfg, h: int, w: int) -> list:
    """(S, C, groups) of every GroupNorm in one forward of the UNet of
    ``cfg`` at h x w latents, in the order it runs them: each resnet's
    norm1 (its input, skip included on the up path) and norm2, each
    transformer's norm, conv_norm_out."""
    chans, g = list(cfg.block_out_channels), cfg.norm_num_groups
    n, per = len(chans), cfg.layers_per_block
    out, skips, ci = [], [chans[0]], chans[0]
    for i, ch in enumerate(chans):
        for _ in range(per):
            out += [(h * w, ci, g), (h * w, ch, g)]
            if i < n - 1:
                out.append((h * w, ch, g))
            skips.append(ch)
            ci = ch
        if i < n - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            skips.append(ch)
    mid = chans[-1]
    out += [(h * w, mid, g)] * 5                 # resnet, attention, resnet
    prev = mid
    for i, ch in enumerate(reversed(chans)):
        for _ in range(per + 1):
            out += [(h * w, prev + skips.pop(), g), (h * w, ch, g)]
            if i > 0:
                out.append((h * w, ch, g))
            prev = ch
        if i < n - 1:
            h, w = 2 * h, 2 * w
    return out + [(h * w, chans[0], g)]


def unet_gn_launches(cfg, h: int, w: int) -> dict:
    """B6 and B5 launches of one bf16 UNet step, from the GroupNorm gates
    as the switches stand: the fused kernel where ``takes_fused_kernel``
    holds, else the plain form, whose statistics take B5 where
    ``takes_stats_kernel`` holds."""
    from safe_denoiser_tpu_torch.ops import group_norm as gn

    counts = {"gn_fused": 0, "gn_stats": 0}
    for s, c, g in unet_norm_shapes(cfg, h, w):
        if gn.takes_fused_kernel(s, c, g):
            counts["gn_fused"] += 1
        elif gn.takes_stats_kernel(s, c):
            counts["gn_stats"] += 1
    return counts


def phase_env() -> str:
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no output"
    print(card)
    print(f"tf32 before: cudnn={torch.backends.cudnn.allow_tf32} "
          f"matmul={torch.backends.cuda.matmul.allow_tf32}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32 now: cudnn=False matmul=False")
    return card


def ptxas_entries(log: str) -> list:
    """(kernel function, registers, spill store bytes, spill load bytes,
    static shared bytes) per entry function of an ``nvcc -Xptxas -v`` log;
    the function is its mangled name (template arguments included)."""
    import re

    rows, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            sm = re.search(r"(\d+) bytes smem", line)
            rows.append((fn, int(m.group(1)), *spill,
                         int(sm.group(1)) if sm else 0))
            fn, spill = None, (0, 0)
    return rows


def phase_build() -> None:
    from safe_denoiser_tpu_torch.ops import _build
    secs = _build.build_all()
    print(f"build: nvcc {len(_build.SOURCES)} sources in {secs:.1f} s "
          f"into {_build.BUILD_DIR}")


def dynamic_smem(name: str, fn: str):
    """The dynamic shared memory (bytes) that the C side gives kernel
    function ``fn`` of ``csrc/<name>.cu``: every template of the bf16
    attention core (B1, B9, B10 share csrc/attention_hopper.cuh, whose
    size B1's library reports) and of its int8 form (B8), and the three
    forms of the conv core (B4, B3 and B7, csrc/conv_hopper.cuh); None for
    the rest."""
    import re

    from safe_denoiser_tpu_torch.ops import _build

    m = re.search(r"attn_kernelILi(\d+)E", fn)
    if name in ("attention", "attention_nt", "attention_bshd") and m:
        return _build.library("attention").sdt_self_attention_bf16_smem(
            int(m.group(1)))
    m = re.search(r"attn_i8_kernelILi(\d+)E", fn)
    if name == "attention_i8" and m:
        return _build.library(name).sdt_self_attention_i8_bf16_smem(
            int(m.group(1)))
    if (name in ("conv3x3", "conv3x3_up") and "conv_kernel" in fn
            or name == "conv3x3_up_interleave" and "up4_kernel" in fn):
        return getattr(_build.library(name), f"sdt_{name}_bf16_smem")()
    return None


def print_ptxas() -> None:
    """ptxas' registers, spills and static shared memory of every kernel of
    every source (from the report kept beside its library), its warnings
    (C7512/C7513: wgmma serialized), and the dynamic shared memory of the
    attention core's templates (B1, B8) and of B4, B3 and B7 (B2's and
    B6's depend on the shape: their phase-3 rows print it)."""
    from safe_denoiser_tpu_torch.ops import _build

    for name in _build.SOURCES:
        log = _build.ptxas_report(name)
        entries = ptxas_entries(log)
        if not entries:
            fail(f"no ptxas report for {name}.cu")
        for fn, regs, st, ld, smem in entries:
            dyn = dynamic_smem(name, fn)
            extra = "" if dyn is None else \
                f", {dyn} bytes dynamic shared memory"
            if name in ("rbf", "group_norm"):
                extra = (", a cluster kernel: dynamic shared memory and "
                         "cluster size from each shape's plan (phase-3 "
                         "rows)")
            print(f"  ptxas {name} {fn}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads, {smem} bytes "
                  f"static shared memory{extra}")
        for line in log.splitlines():
            if "warning" in line or "(C75" in line:
                print(f"  ptxas {name}: {line.strip()}")


def _report(name, shape, err, tol, ms, plain_ms, lib_ms, bnd, lib_label,
            dev, metric="max|d|"):
    """One phase-3 row. ``dev``: (the kernel's device_ms, the library
    call's device_ms or None where no PyTorch call computes the function);
    ``ms``/``lib_ms`` are cuda_ms, wrapper-paced."""
    def f(v):
        return "null" if v is None else f"{v:.4f}"

    print(f"kernel {name} {shape}: {metric}={err:.3e} tol={tol:.1e} "
          f"kernel_device_ms={f(dev[0])} library_device_ms={f(dev[1])} "
          f"bound_ms={bnd[0]:.4f} ({bnd[1]}) ({lib_label}); wrapper-paced: "
          f"kernel_ms={ms:.4f} library_ms={f(lib_ms)} plain_ms={plain_ms:.4f}")
    if not err <= tol:
        fail(f"{name} {shape}: {metric} {err:.3e} above tolerance {tol:.1e}")
    if dev[0] is None or (lib_ms is None) != (dev[1] is None):
        fail(f"{name} {shape}: a device time is missing")


def _attn_err(out, want, dtype):
    """(error, tolerance, metric label) of an attention kernel's output
    against its plain version in f32: max |d| within attention.BF16_ATOL
    for bf16; for f32 the largest |d| - F32_TOL * |plain| within F32_TOL
    (B1's f32 GPU test bound)."""
    from safe_denoiser_tpu_torch.ops import attention

    d = (out.float() - want).abs()
    if dtype == torch.bfloat16:
        return d.max().item(), attention.BF16_ATOL, "max|d|"
    return ((d - F32_TOL * want.abs()).max().item(), F32_TOL,
            f"max(|d|-{F32_TOL}*|plain|)")


def b8_errors(shape, seed: int):
    """B8 on seeded bf16 [B,S,H,D] inputs (q >= 0 and k <= 0 at S = 600,
    so every real logit is negative and an unmasked padded key would
    dominate): (q, k, v, max|B8 - plain|, max|B1 - plain|), the plain
    version being ``attention_i8_ref`` on the same values in f32. The
    second distance is what a B8 that skipped the quantization would
    read."""
    from safe_denoiser_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, device="cuda", generator=g)
               for _ in range(3))
    if shape[1] == 600:
        q, k = q.abs(), -k.abs()
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    scale = shape[3] ** -0.5
    want = attention.attention_i8_ref(q.float(), k.float(), v.float(), scale)
    out = attention._self_attention_i8_cuda(q, k, v, scale)
    err = (out.float() - want).abs().max().item()
    out = attention._self_attention_cuda(q, k, v, scale)
    ctrl = (out.float() - want).abs().max().item()
    return q, k, v, err, ctrl


def b8_parts(q, k, v, scale):
    """Device times of B8's two kernels alone on the wrapper's scratch:
    (the quantize pass over q and k, the core's int8 form)."""
    from safe_denoiser_tpu_torch.ops import _build, attention

    lib = _build.library("attention_i8")
    b, s, h, d = q.shape
    qi = torch.empty(2, b * h * s * attention.i8_width(d), dtype=torch.int8,
                     device=q.device)
    deq = torch.empty(2 * b * h * attention.i8_pitch(s), dtype=torch.float32,
                      device=q.device)
    out = torch.empty_like(q)
    cq, ck = attention.i8_dequant_scales(scale)

    def quantize():
        _build.check(lib.sdt_quantize_i8_bf16(
            q.data_ptr(), k.data_ptr(), qi[0].data_ptr(), qi[1].data_ptr(),
            deq.data_ptr(), b, s, h, d, *q.stride()[:3], cq, ck,
            _build.stream_ptr(q.device)), "sdt_quantize_i8_bf16")

    def attend():
        _build.check(lib.sdt_attention_i8_quantized_bf16(
            qi[0].data_ptr(), qi[1].data_ptr(), deq.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, h, d, *v.stride()[:3],
            _build.stream_ptr(q.device)), "sdt_attention_i8_quantized_bf16")

    quantize()
    torch.cuda.synchronize()
    return device_ms(quantize), device_ms(attend)


def phase_kernels() -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns per-kernel numbers at its most frequent main-path shape."""
    import torch.nn.functional as F

    from safe_denoiser_tpu_torch.models import SD3_VAE
    from safe_denoiser_tpu_torch.ops import (
        attention, conv3x3, group_norm, repellency_kernels)

    print_ptxas()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    # the SD3 decode's shapes (1 image at 1024^2), from the routing
    sd3 = vae_kernel_plan(SD3_VAE, 1, SD3_SIDE // 8, SD3_SIDE // 8)[1]

    # B1 self-attention, bf16 [B,S,H,D]: compared with the plain version on
    # the same inputs upcast to f32, within attention.BF16_ATOL (bf16 P and
    # output; tight enough that a lost tail mask at S=600 fails). SD-v1's
    # two shapes, a tail, SD3's joint attention, and a tail at SD3's D=64
    # whose real logits are all negative (q >= 0, k <= 0)
    for b, s, h, d in ((8, 4096, 8, 40), (8, 1024, 8, 80), (2, 600, 8, 40),
                       (2, 4429, 24, 64), (2, 600, 24, 64)):
        q, k, v = (torch.randn(b, s, h, d, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        if (s, d) == (600, 64):
            q, k = q.abs(), -k.abs()
        scale = d ** -0.5
        out = attention.self_attention(q, k, v, scale)
        want = attention.attention_ref(q.float(), k.float(), v.float(), scale)
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        ms = cuda_ms(lambda: attention.self_attention(q, k, v, scale))
        plain = cuda_ms(lambda: attention.attention_ref(q, k, v, scale),
                        reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        dtm = (device_ms(lambda: attention.self_attention(q, k, v, scale)),
               device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))
        bnd = bound_ms(4 * b * s * h * d * 2, attention.flops(b, s, h, d),
                       PEAK_BF16)
        _report("attention", [b, s, h, d], err, attention.BF16_ATOL, ms,
                plain, lib, bnd, "F.scaled_dot_product_attention", dtm)
        del want
        if "attention" not in results:
            results["attention"] = dict(err=err, ms=ms, plain=plain, lib=lib,
                                        bound=bnd, dev=dtm)
        results["attention"]["err"] = max(results["attention"]["err"], err)

    # B8 int8-QK^T self-attention, bf16 [B,S,H,D]: against its plain
    # version (the same quantization in f32, exact integer logits) on the
    # same values, within B8_ATOL of its shape (see there); the SD3 joint
    # attention first, then SD-v1's two and a tail whose real logits are
    # all negative. No PyTorch call computes int8-QK^T attention
    # (library_ms null); SDPA in bf16 at the same shape is printed as
    # context only.
    for i, shape in enumerate(B8_ATOL):
        b, s, h, d = shape
        tol = B8_ATOL[shape]
        q, k, v, err, ctrl = b8_errors(shape, seed=i)
        print(f"  attention_i8 {list(shape)}: B1 (no quantization) on the "
              f"same inputs max|d|={ctrl:.3e}")
        if not ctrl > tol:
            fail(f"attention_i8 {list(shape)}: bound {tol:.1e} does not "
                 f"separate B8 from B1 (B1 max|d| {ctrl:.3e})")
        scale = d ** -0.5
        ms = cuda_ms(lambda: attention._self_attention_i8_cuda(q, k, v,
                                                               scale))
        plain = cuda_ms(lambda: attention.attention_i8_ref(q, k, v, scale),
                        reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        dtm = (device_ms(lambda: attention._self_attention_i8_cuda(
            q, k, v, scale)), None)
        sdpa_dev = device_ms(lambda: F.scaled_dot_product_attention(qt, kt,
                                                                    vt))
        half = attention.flops(b, s, h, d) / 2     # QK^T int8, P V bf16
        t_ops = (half / PEAK_INT8 + half / PEAK_BF16) * 1e3
        t_bytes = 4 * b * s * h * d * 2 / PEAK_BYTES * 1e3
        bnd = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                               "bytes")
        # its two kernels alone; the pass's bound: q, k read in bf16, the
        # int8 rows (padded to i8_width) and the f32 factors written
        quant_ms, attn_ms = b8_parts(q, k, v, scale)
        quant_bytes = b * h * s * (4 * d + 2 * attention.i8_width(d) + 8)
        print(f"  attention_i8 {list(shape)}: quantize pass device_ms="
              f"{quant_ms:.4f} (bound {quant_bytes / PEAK_BYTES * 1e3:.4f} "
              f"bytes), int8 attention device_ms={attn_ms:.4f}")
        _report("attention_i8", list(shape), err, tol, ms,
                plain, None, bnd, f"none; SDPA bf16 device {sdpa_dev:.4f} "
                f"ms, wrapper-paced {sdpa:.4f} ms, as context", dtm)
        if "attention_i8" not in results:
            results["attention_i8"] = dict(err=err, ms=ms, plain=plain,
                                           lib=None, bound=bnd, dev=dtm)
        results["attention_i8"]["err"] = max(results["attention_i8"]["err"],
                                             err)

    # B9 head-major attention on [BH, S, D] as the nt layout hands it over:
    # SD3's joint attention padded to 4608 with valid_kv 4429 (the padded
    # keys are zero rows and must be masked), SD-v1's two shapes, a tail
    # whose real logits are all negative (q >= 0, k <= 0: a weighed zero key
    # would dominate), then the f32 entry. bf16 within attention.BF16_ATOL
    # of the plain version on the same values in f32; f32 within B1's f32
    # bound (|d| <= F32_TOL + F32_TOL * |plain|, reported as the excess over
    # the relative term). Library: SDPA over the valid keys. Bound: the
    # valid rows' work, 4 * BH * valid^2 * D operations.
    for bh, s, d, valid, dtype in ((48, 4608, 64, 4429, torch.bfloat16),
                                   (64, 4096, 40, None, torch.bfloat16),
                                   (64, 1024, 80, None, torch.bfloat16),
                                   (16, 1024, 40, 600, torch.bfloat16),
                                   (16, 1024, 64, 600, torch.float32)):
        q, k, v = (torch.randn(bh, s, d, device=dev, generator=g)
                   for _ in range(3))
        if valid is not None:
            k[:, valid:] = 0
            v[:, valid:] = 0
            if dtype == torch.bfloat16 and s == 1024:
                q, k = q.abs(), -k.abs()
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        scale, n = d ** -0.5, valid or s
        out = attention.attention_nt(q, k, v, scale, valid)
        want = attention.attention_nt_ref(q.float(), k.float(), v.float(),
                                          scale, valid)
        torch.cuda.synchronize()
        err, tol, metric = _attn_err(out, want, dtype)
        ms = cuda_ms(lambda: attention.attention_nt(q, k, v, scale, valid))
        plain = cuda_ms(lambda: attention.attention_nt_ref(q, k, v, scale,
                                                           valid),
                        reps=3, warmup=1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None, :, :n], v[None, :, :n]))
        dtm = (device_ms(lambda: attention.attention_nt(q, k, v, scale,
                                                        valid)),
               device_ms(lambda: F.scaled_dot_product_attention(
                   q[None], k[None, :, :n], v[None, :, :n])))
        bnd = bound_ms(4 * bh * s * d * q.element_size(),
                       4 * bh * n * n * d,
                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
        _report("attention_nt", [bh, s, d, f"valid_kv={n}", str(dtype)[6:]],
                err, tol, ms, plain, lib, bnd,
                "F.scaled_dot_product_attention over the valid keys", dtm,
                metric=metric)
        del want
        if "attention_nt" not in results:
            results["attention_nt"] = dict(err=err, ms=ms, plain=plain,
                                           lib=lib, bound=bnd, dev=dtm)
        if dtype == torch.bfloat16:
            results["attention_nt"]["err"] = max(
                results["attention_nt"]["err"], err)

    # B10 natural-layout attention on [B, S, H, D], S % 512 == 0: SD-v1's
    # two shapes in bf16, then the f32 entry; bounds and library as B1's
    for b, s, h, d, dtype in ((8, 4096, 8, 40, torch.bfloat16),
                              (8, 1024, 8, 80, torch.bfloat16),
                              (2, 1024, 8, 40, torch.float32)):
        q, k, v = (torch.randn(b, s, h, d, device=dev, generator=g)
                   .to(dtype) for _ in range(3))
        scale = d ** -0.5
        out = attention.attention_bshd(q, k, v, scale)
        want = attention.attention_bshd_ref(q.float(), k.float(), v.float(),
                                            scale)
        torch.cuda.synchronize()
        err, tol, metric = _attn_err(out, want, dtype)
        ms = cuda_ms(lambda: attention.attention_bshd(q, k, v, scale))
        plain = cuda_ms(lambda: attention.attention_bshd_ref(q, k, v, scale),
                        reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        dtm = (device_ms(lambda: attention.attention_bshd(q, k, v, scale)),
               device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))
        bnd = bound_ms(4 * b * s * h * d * q.element_size(),
                       attention.flops(b, s, h, d),
                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
        _report("attention_bshd", [b, s, h, d, str(dtype)[6:]], err, tol,
                ms, plain, lib, bnd, "F.scaled_dot_product_attention", dtm,
                metric=metric)
        del want
        if "attention_bshd" not in results:
            results["attention_bshd"] = dict(err=err, ms=ms, plain=plain,
                                             lib=lib, bound=bnd, dev=dtm)
        if dtype == torch.bfloat16:
            results["attention_bshd"]["err"] = max(
                results["attention_bshd"]["err"], err)

    # B11 / B12 head repacks, bf16 copies: bit-exact (torch.equal) against
    # the plain versions, at SD3's joint shape and SD-v1's two; library:
    # the transpose + contiguous() copy; bound: bytes read and written
    for b, s, h, d in ((2, 4608, 24, 64), (8, 4096, 8, 40), (8, 1024, 8, 80)):
        x = torch.randn(b, s, h * d, device=dev, generator=g).bfloat16()
        heads = attention.repack_to_heads(x, h)
        for name, fn, plain_fn, lib_fn, arg in (
                ("repack_to_heads", lambda t: attention.repack_to_heads(t, h),
                 lambda t: attention.repack_to_heads_ref(t, h),
                 lambda t: t.view(b, s, h, d).transpose(1, 2).contiguous(),
                 x),
                ("repack_from_heads", attention.repack_from_heads,
                 attention.repack_from_heads_ref,
                 lambda t: t.transpose(1, 2).reshape(b, s, h * d), heads)):
            out, want = fn(arg), plain_fn(arg)
            torch.cuda.synchronize()
            err = 0.0 if torch.equal(out, want) else \
                (out.float() - want.float()).abs().max().item() or 1.0
            ms = cuda_ms(lambda: fn(arg), reps=20)
            plain = cuda_ms(lambda: plain_fn(arg), reps=20)
            lib = cuda_ms(lambda: lib_fn(arg), reps=20)
            dtm = (device_ms(lambda: fn(arg), reps=20),
                   device_ms(lambda: lib_fn(arg), reps=20))
            bnd = bound_ms(2 * arg.nbytes, 0, PEAK_BF16)
            _report(name, [b, s, h, d], err, 0.0, ms, plain, lib, bnd,
                    "transpose(1, 2) + contiguous copy", dtm,
                    metric="max|d| (0: bit-exact)")
            if name not in results:
                results[name] = dict(err=err, ms=ms, plain=plain, lib=lib,
                                     bound=bnd, dev=dtm)
            results[name]["err"] = max(results[name]["err"], err)
        if not torch.equal(attention.repack_from_heads(heads), x):
            fail(f"repack_from_heads(repack_to_heads(x)) != x at "
                 f"{[b, s, h, d]}")

    # B2 rbf score, f32: x near the bank rows so the weights span 1e-3..1;
    # SD-v1's [4, 16384] against 515 rows, then SD3's one [16, 128, 128]
    # latent (D = 262144) against its 16-latent bank, then CoPro's one
    # [4, 64, 64] latent against its 3000-row bank
    for n, m, cc, hw in ((4, 515, 4, 64), (1, 16, 16, 128),
                         (1, COPRO_BANK, 4, 64)):
        dd = cc * hw * hw
        refs = torch.randn(m, cc, hw, hw, device=dev, generator=g)
        refs = (refs / refs.norm(dim=1, keepdim=True)).reshape(m, dd)
        x = refs[:n] + 0.1 * torch.randn(n, dd, device=dev, generator=g)
        for normalize in (True, False):
            def kernel():
                return repellency_kernels.rbf_negative_score(
                    x, refs, 3.15, 1e-8, normalize=normalize)

            def plain_fn():
                return repellency_kernels.rbf_negative_score_ref(
                    x, refs, 3.15, 1e-8, normalize=normalize)

            (num, beta), (wn, wb) = kernel(), plain_fn()
            torch.cuda.synchronize()
            err = max((num - wn).abs().max().item(),
                      ((beta - wb).abs() / wb.abs()).max().item())
            ms, plain = cuda_ms(kernel), cuda_ms(plain_fn)
            dtm = (device_ms(kernel), None)
            bnd = bound_ms((m * dd + 2 * n * dd + n) * 4, 4 * n * m * dd,
                           PEAK_F32)
            p = repellency_kernels.rbf_plan(n, m, dd, 4)
            plan = (f"plan: pass 1 clusters of {p.cl1} D-slices of {p.ds} "
                    f"columns, {p.mr} rows a block; pass 2 clusters of "
                    f"{p.cl2} runs of {p.ms} rows, {n * 128 * p.vec * 4} "
                    f"bytes dynamic shared memory")
            _report("rbf", [n, dd, m, f"normalize={normalize}"], err, 1e-4,
                    ms, plain, None, bnd, f"no single PyTorch call; {plan}",
                    dtm)
            if normalize and "rbf" not in results:
                results["rbf"] = dict(err=err, ms=ms, plain=plain, lib=None,
                                      bound=bnd, dev=dtm)
            results["rbf"]["err"] = max(results["rbf"]["err"], err)

    # B2's raw form (normalize=False) at the bank-sharded shapes of phase
    # 11: SD-v1's 515 rows padded to 516 over 4 slots (129 a shard, the
    # last shard ending in a PAD row) and SD3's 16 latents over 4 slots
    # (one shard here ending in a PAD row too); a PAD row's weight must
    # underflow to exactly 0 (||r||^2 = 1.6e24 / 2.6e25), never inf or NaN
    from safe_denoiser_tpu_torch.parallel import PAD_VALUE
    results["rbf"]["raw_shards"] = []
    for n, m, cc, hw in ((4, 129, 4, 64), (1, 4, 16, 128)):
        dd = cc * hw * hw
        refs = torch.randn(m, cc, hw, hw, device=dev, generator=g)
        refs = (refs / refs.norm(dim=1, keepdim=True)).reshape(m, dd)
        x = refs[:n] + 0.1 * torch.randn(n, dd, device=dev, generator=g)
        refs[-1] = PAD_VALUE

        def kernel():
            return repellency_kernels.rbf_negative_score(
                x, refs, 3.15, 1e-8, normalize=False)

        def plain_fn():
            return repellency_kernels.rbf_negative_score_ref(
                x, refs, 3.15, 1e-8, normalize=False)

        (num, beta), (wn, wb) = kernel(), plain_fn()
        (pad_num, pad_beta) = repellency_kernels.rbf_negative_score(
            x, refs[-1:].contiguous(), 3.15, 1e-8, normalize=False)
        torch.cuda.synchronize()
        err = max((num - wn).abs().max().item(),
                  ((beta - wb).abs() / wb.abs()).max().item())
        if not (bool(torch.isfinite(num).all()) and not pad_num.any()
                and not pad_beta.any()):
            fail(f"rbf raw [{n},{dd}] x {m}: a PAD row gave a non-zero or "
                 "non-finite partial")
        ms, plain = cuda_ms(kernel), cuda_ms(plain_fn)
        dtm = (device_ms(kernel), None)
        bnd = bound_ms((m * dd + 2 * n * dd + n) * 4, 4 * n * m * dd,
                       PEAK_F32)
        _report("rbf", [n, dd, m, "normalize=False", "shard, PAD row"], err,
                1e-4, ms, plain, None, bnd, "no single PyTorch call", dtm)
        results["rbf"]["err"] = max(results["rbf"]["err"], err)
        results["rbf"]["raw_shards"].append(dict(
            shape=[n, dd, m], device_ms=dtm[0], bound_ms=bnd[0],
            bound_by=bnd[1], max_abs_err=err, plain_ms=plain))

    # B3 upsample-fused conv, bf16 NHWC; plain version in f32 (TF32 off) on
    # the same bf16 values. Tolerance: outputs ~ N(0, 2) rounded to bf16
    # (half an ulp is 1.6e-2 at |y| = 8) plus the bf16 rounding of the
    # kernel's pre-summed weights. Timed with the weights packed once, as
    # the main path's modules call it
    for b, h2, w2, ci, co in ((8, 32, 32, 640, 640), (4, 64, 64, 512, 512),
                              (4, 128, 128, 512, 512),
                              (4, 256, 256, 256, 256),
                              *((b, h, w, c, c)
                                for b, h, w, c in sd3["conv3x3_up"])):
        hh = torch.randn(b, h2, w2, ci, device=dev,
                         generator=g).to(torch.bfloat16)
        w = (torch.randn(co, ci, 3, 3, device=dev, generator=g)
             / (9 * ci) ** 0.5).to(torch.bfloat16)
        bias = torch.randn(co, device=dev, generator=g).to(torch.bfloat16)
        if not conv3x3.supports_up((b, h2, w2, ci), ci, co):
            fail(f"conv3x3_up shape {[b, h2, w2, ci, co]} not supported")
        out = conv3x3.conv3x3_up(hh, w, bias)
        want = conv3x3.conv3x3_up_ref(hh.float(), w.float(), bias.float())
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        del out, want
        packed = conv3x3.pack_weights(w, bias)

        def kernel():
            return conv3x3.conv3x3_up(hh, w, bias, packed)

        hn = hh.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(F.interpolate(hn, scale_factor=2,
                                          mode="nearest"), w, bias, padding=1)

        ms = cuda_ms(kernel)
        plain = cuda_ms(lambda: conv3x3.conv3x3_up_ref(hh, w, bias), reps=3)
        lib = cuda_ms(library)
        dtm = (device_ms(kernel), device_ms(library))
        bnd = bound_ms((b * h2 * w2 * ci + co * ci * 9 + co
                        + b * 4 * h2 * w2 * co) * 2,
                       conv3x3.flops(b, h2, w2, ci, co), PEAK_BF16)
        _report("conv3x3_up", [b, h2, w2, ci, co], err, 5e-2, ms, plain, lib,
                bnd, "F.interpolate + F.conv2d, two calls", dtm)
        del hn
        if "conv3x3_up" not in results:
            results["conv3x3_up"] = dict(err=err, ms=ms, plain=plain,
                                         lib=lib, bound=bnd, dev=dtm)
        results["conv3x3_up"]["err"] = max(results["conv3x3_up"]["err"], err)

    # B4 fused conv, bf16 NHWC, at each VAE resnet shape with the main
    # path's argument mix: conv1 (GN affine + SiLU), and where Ci == Co
    # conv2 (+ the residual); against the plain version on the same values,
    # elementwise within conv3x3.BF16_ATOL + BF16_RTOL * |plain| (reported
    # as the largest |d| - BF16_RTOL * |plain|). The library yardstick is
    # the composition: affine + SiLU, F.conv2d (cuDNN), residual add.
    # Decoder shapes at batch 4 (sd14-main), then the encoder's at the
    # runner's bank chunk of 16 (Ci < Co in the first conv of down_blocks
    # 1 and 2), then the SD3 decode's at batch 1 (up to 1024^2); the plain
    # version is timed once at batch 16.
    sd3_b4 = []
    for b, h, w, ci, co, _ in sd3["conv3x3"]:
        if (b, h, w, ci, co) not in sd3_b4:
            sd3_b4.append((b, h, w, ci, co))
    for b, h, w, ci, co in ((4, 64, 64, 512, 512), (4, 128, 128, 512, 512),
                            (4, 256, 256, 512, 256), (4, 256, 256, 256, 256),
                            (4, 512, 512, 256, 128), (4, 512, 512, 128, 128),
                            (16, 512, 512, 128, 128),
                            (16, 256, 256, 128, 256),
                            (16, 256, 256, 256, 256),
                            (16, 128, 128, 256, 512),
                            (16, 128, 128, 512, 512), (16, 64, 64, 512, 512),
                            *sd3_b4):
        if not conv3x3.supports((b, h, w, ci), ci, co):
            fail(f"conv3x3 shape {[b, h, w, ci, co]} not supported")
        x = torch.randn(b, h, w, ci, device=dev, generator=g).bfloat16()
        wt = (torch.randn(co, ci, 3, 3, device=dev, generator=g)
              / (9 * ci) ** 0.5).bfloat16()
        bias = 0.1 * torch.randn(co, device=dev, generator=g)
        a = 1.0 + 0.2 * torch.randn(b, ci, device=dev, generator=g)
        s = 0.5 * torch.randn(b, ci, device=dev, generator=g)
        packed = conv3x3.pack_weights_3x3(wt, bias)
        xn = x.permute(0, 3, 1, 2)                       # channels_last
        ab, sb = (t.bfloat16()[:, :, None, None] for t in (a, s))
        mixes = [None]
        if ci == co:
            mixes.append(torch.randn(b, h, w, co, device=dev,
                                     generator=g).bfloat16())
        for r in mixes:
            def kernel():
                return conv3x3.conv3x3(x, wt, bias, a, s, "silu", r,
                                       packed=packed)

            def library():
                y = F.conv2d(F.silu(xn * ab + sb), wt, bias.bfloat16(),
                             padding=1)
                return y if r is None else y + r.permute(0, 3, 1, 2)

            out = kernel()
            want = conv3x3.conv3x3_ref(x, wt, bias, a, s, "silu", r)
            torch.cuda.synchronize()
            d = (out.float() - want.float()).abs()
            excess = (d - conv3x3.BF16_RTOL * want.float().abs()).max().item()
            err = d.max().item()
            del out, want, d
            ms = cuda_ms(kernel)
            plain = cuda_ms(lambda: conv3x3.conv3x3_ref(x, wt, bias, a, s,
                                                        "silu", r),
                            reps=1 if b == 16 else 3, warmup=1)
            lib = cuda_ms(library)
            dtm = (device_ms(kernel), device_ms(library))
            n_io = b * h * w * (ci + co * (1 if r is None else 2))
            bnd = bound_ms((n_io + 9 * ci * co) * 2 + (co + 2 * b * ci) * 4,
                           conv3x3.flops_3x3(b, h, w, ci, co), PEAK_BF16)
            mix = "conv1" if r is None else "conv2+residual"
            print(f"  conv3x3 {mix} max|d|={err:.3e}")
            _report("conv3x3", [b, h, w, ci, co, mix], excess,
                    conv3x3.BF16_ATOL, ms, plain, lib, bnd,
                    "affine+SiLU, F.conv2d, +residual", dtm,
                    metric=f"max(|d|-{conv3x3.BF16_RTOL}*|plain|)")
            if "conv3x3" not in results:
                results["conv3x3"] = dict(err=err, ms=ms, plain=plain,
                                          lib=lib, bound=bnd, dev=dtm)
            results["conv3x3"]["err"] = max(results["conv3x3"]["err"], err)
        del x, mixes

    # B5 GN statistics, bf16 [B,S,C] -> f32 sums, at every shape the main
    # path gives it (UNet up_blocks[3] norm1, then the VAE decoder's norms
    # from 64^2 x 512 to 512^2 x 128), then the encoder's at the runner's
    # bank chunk of 16, then the SD3 decode's; tolerance relative to the
    # sum of |x| (order of summation differs)
    for b, s, c in ((8, 4096, 640), (8, 4096, 960), (4, 4096, 512),
                    (4, 16384, 512), (4, 65536, 512), (4, 65536, 256),
                    (4, 262144, 256), (4, 262144, 128),
                    (16, 262144, 128), (16, 65536, 128), (16, 65536, 256),
                    (16, 16384, 256), (16, 16384, 512), (16, 4096, 512),
                    *sd3["gn_stats"]):
        xx = torch.randn(b, s, c, device=dev,
                         generator=g).to(torch.bfloat16) + 0.5
        s1, s2 = group_norm.gn_stats(xx)
        w1, w2 = group_norm.gn_stats_ref(xx)
        torch.cuda.synchronize()
        scale1 = xx.float().abs().sum(1)
        err = max(((s1 - w1).abs() / scale1).max().item(),
                  ((s2 - w2).abs() / w2).max().item())
        ms = cuda_ms(lambda: group_norm.gn_stats(xx))
        plain = cuda_ms(lambda: group_norm.gn_stats_ref(xx))
        lib = cuda_ms(lambda: (xx.float().sum(1), (xx.float() ** 2).sum(1)))
        dtm = (device_ms(lambda: group_norm.gn_stats(xx)),
               device_ms(lambda: (xx.float().sum(1),
                                  (xx.float() ** 2).sum(1))))
        bnd = bound_ms(b * s * c * 2 + 2 * b * c * 4, 3 * b * s * c, PEAK_F32)
        _report("gn_stats", [b, s, c], err, 1e-5, ms, plain, lib, bnd,
                "x.float().sum(1), (x.float()**2).sum(1)", dtm)
        if "gn_stats" not in results:
            results["gn_stats"] = dict(err=err, ms=ms, plain=plain, lib=lib,
                                       bound=bnd, dev=dtm)
        results["gn_stats"]["err"] = max(results["gn_stats"]["err"], err)

    # B7 interleaved upsample conv at the VAE decoders' upsamples (SD-v1 at
    # batch 4, then SD3's at 1), against the plain version in f32 on the
    # same bf16 values within B3's bound (5e-2); timed beside B3 on the same
    # inputs; bound and library as B3's
    for b, h2, w2, c in ((4, 64, 64, 512), (4, 128, 128, 512),
                         (4, 256, 256, 256), *sd3["conv3x3_up"]):
        hh = torch.randn(b, h2, w2, c, device=dev,
                         generator=g).to(torch.bfloat16)
        w = (torch.randn(c, c, 3, 3, device=dev, generator=g)
             / (9 * c) ** 0.5).to(torch.bfloat16)
        bias = torch.randn(c, device=dev, generator=g).to(torch.bfloat16)
        packed = conv3x3.pack_weights(w, bias)
        out = conv3x3.conv3x3_up(hh, w, bias, packed, form="interleave")
        want = conv3x3.conv3x3_up_ref(hh.float(), w.float(), bias.float())
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        del out, want
        ms = cuda_ms(lambda: conv3x3.conv3x3_up(hh, w, bias, packed,
                                                form="interleave"))
        plain = cuda_ms(lambda: conv3x3.conv3x3_up_ref(hh, w, bias), reps=3)
        hn = hh.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(F.interpolate(hn, scale_factor=2,
                                          mode="nearest"), w, bias, padding=1)

        lib = cuda_ms(library)
        dtm = (device_ms(lambda: conv3x3.conv3x3_up(hh, w, bias, packed,
                                                    form="interleave")),
               device_ms(library))
        b3 = device_ms(lambda: conv3x3.conv3x3_up(hh, w, bias, packed))
        bnd = bound_ms((b * h2 * w2 * c + c * c * 9 + c
                        + b * 4 * h2 * w2 * c) * 2,
                       conv3x3.flops(b, h2, w2, c, c), PEAK_BF16)
        _report("conv3x3_up_interleave", [b, h2, w2, c, c], err, 5e-2, ms,
                plain, lib, bnd, f"F.interpolate + F.conv2d, two calls; B3 "
                f"device {b3:.4f} ms, B7/B3 {dtm[0] / b3:.3f}", dtm)
        del hn
        if "conv3x3_up_interleave" not in results:
            results["conv3x3_up_interleave"] = dict(err=err, ms=ms,
                                                    plain=plain, lib=lib,
                                                    bound=bnd, dev=dtm)
        results["conv3x3_up_interleave"]["err"] = max(
            results["conv3x3_up_interleave"]["err"], err)

    # B6 fused GroupNorm + SiLU, [B,S,C] at the UNet's admitted shapes with
    # 32 groups (the largest, a 1280-wide one, the 2560-wide one at S = 64)
    # in bf16, then the first in f32; x ~ N(1, 2^2). Against the plain
    # version on the same values: bf16 within one bf16 ulp of max|y| (the
    # same f32 value may round to a neighbouring bf16 value), f32 within
    # 1e-4 (sums in another order). Library: F.group_norm + F.silu on the
    # channels_last NCHW view. Bound: one read and one write of x.
    for b, s, c, dtype in GN_SHAPES:
        xx = (torch.randn(b, s, c, device=dev, generator=g) * 2 + 1).to(dtype)
        sc = 1 + 0.2 * torch.randn(c, device=dev, generator=g)
        bi = 0.5 * torch.randn(c, device=dev, generator=g)
        out = group_norm.group_norm_fused(xx, sc, bi, 32, 1e-5, "silu")
        want = group_norm.group_norm_fused_ref(xx, sc, bi, 32, 1e-5, "silu")
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        tol = (2.0 ** (math.floor(math.log2(top)) - 7)
               if dtype == torch.bfloat16 else 1e-4)
        ms = cuda_ms(lambda: group_norm.group_norm_fused(xx, sc, bi, 32,
                                                         1e-5, "silu"))
        plain = cuda_ms(lambda: group_norm.group_norm_fused_ref(
            xx, sc, bi, 32, 1e-5, "silu"))
        side = int(round(s ** 0.5))
        xn = xx.view(b, side, side, c).permute(0, 3, 1, 2)
        scd, bid = sc.to(dtype), bi.to(dtype)
        lib = cuda_ms(lambda: F.silu(F.group_norm(xn, 32, scd, bid, 1e-5)))
        dtm = (device_ms(lambda: group_norm.group_norm_fused(
                   xx, sc, bi, 32, 1e-5, "silu")),
               device_ms(lambda: F.silu(F.group_norm(xn, 32, scd, bid,
                                                     1e-5))))
        bnd = bound_ms(2 * xx.nbytes + 2 * c * 4, 0, PEAK_F32)
        p = group_norm.gn_plan(b, s, c, 32, xx.element_size())
        reread = device_ms(lambda: group_norm._group_norm_fused_cuda(
            xx, sc, bi, 32, 1e-5, "silu", one_read=False))
        plan = (f"plan: {p.tiles} tiles of {p.ct} channels, clusters of "
                f"{p.cl} blocks of {p.rows} rows, {p.vb}-byte vectors, "
                f"{'one read' if p.resident else 're-read'}, {p.smem} bytes "
                f"dynamic shared memory; the re-read form {reread:.4f} ms")
        _report("gn_fused", [b, s, c, str(dtype)[6:]], err, tol, ms, plain,
                lib, bnd, f"F.silu(F.group_norm) on the NCHW view; {plan}",
                dtm)
        if "gn_fused" not in results:
            results["gn_fused"] = dict(err=err, ms=ms, plain=plain, lib=lib,
                                       bound=bnd, dev=dtm)
        if dtype == torch.bfloat16:
            results["gn_fused"]["err"] = max(results["gn_fused"]["err"], err)
    return results


# The backward kernels' phase-3 shapes, those of the training slice
# (phase 10, batch 1): B1b at the SD-v1 student's two self-attentions and
# SD3's joint attention (flow matching, phase 10b); B5b at the UNet's two
# largest statistics-kernel GroupNorms at 64^2; B3b at the UNet's 640-
# channel 32 -> 64 upsample conv (h [B, H2, W2, Ci])
BWD_B1 = ((1, 4096, 8, 40), (1, 1024, 8, 80), (1, 4429, 24, 64))
BWD_B5 = ((1, 4096, 640), (1, 4096, 960))
BWD_B3 = ((1, 32, 32, 640, 640),)
# bounds of the backward rows, max|kernel - plain| / max|plain| per output
# on the same inputs, plain in f32: B1b rounds P and dS to bf16 for its
# products and writes bf16 (2^-9 and 2^-8 relative a step); B3b-dx folds
# up to four taps into one bf16 weight and writes bf16; B3b-dw sums exact
# bf16 products in f32 in another order (a dropped tap or lost Delta is
# O(1))
BWD_B1_RTOL, BWD_DX_RTOL, BWD_DW_RTOL = 2e-2, 1e-2, 1e-3
# max |lse - plain| (exp2 domain, f32) of the logsumexp B1 keeps for B1b:
# f32 sums of exp2 terms in another order; a row that lost a tile's sum
# or its max is off by O(1)
LSE_ATOL = 1e-3
BWD_KERNELS = ("attention_bwd", "gn_stats_bwd", "conv3x3_up_bwd_dx",
               "conv3x3_up_bwd_dw")


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| (f32)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def dx_sweep(shape, dy, w4, hh) -> None:
    """B3b-dx's conv alone at each tile width and split that its plan
    chooses among (``csrc/conv3x3_up_bwd.cu::dx_plan``), device times,
    beside the clusters of each split that the card holds at once."""
    from safe_denoiser_tpu_torch.ops import _build, conv3x3

    b, h2, w2, ci, co = shape
    lib = _build.library("conv3x3_up_bwd")
    dh = torch.empty_like(hh)
    for tn in conv3x3.DX_TNS:
        times = []
        for split in range(1, 5):
            def tiled(tn=tn, split=split):
                _build.check(lib.sdt_conv3x3_up_bwd_dx_tiled(
                    dy.data_ptr(), w4.data_ptr(), dh.data_ptr(), b, h2, w2,
                    ci, co, tn, split, _build.stream_ptr(dy.device)),
                    "sdt_conv3x3_up_bwd_dx_tiled")
            times.append(device_ms(tiled))
        held = [lib.sdt_conv3x3_up_bwd_dx_clusters(tn, s)
                for s in range(1, 5)]
        print(f"kernel conv3x3_up_bwd_dx {shape}: the conv alone at {tn} "
              "input channels a block, splits 1..4: device_ms="
              + "/".join(f"{t:.4f}" for t in times)
              + f" (clusters held at once: {held})")


# adaln's phase-3 shapes: SD3-medium's image and context rows under CFG
# (B = 2); the MMDiT's 143 sites a transformer call split by mode: norm 49
# (norm1, norm1_context a block, norm_out), residual + norm 47 and residual
# 47 (_finish's, 23 blocks with context and the last without)
ADALN_SHAPES = ((2, 4096, 1536), (2, 333, 1536))
ADALN_MODES = ("norm", "residual+norm", "residual")


def phase_adaln() -> dict:
    """adaln (the MMDiT's gated residual + LayerNorm + modulation, one pass
    over a row) in each mode at ADALN_SHAPES against adaln_ref on the same
    bf16 values, with the device times of the kernel, of the simplest
    library form (the "library" column: ``F.layer_norm``, f32 statistics
    rounded once, and ``torch.addcmul`` for the residual and the
    modulation) and of the eager composition the MMDiT ran before the
    kernel (an f32 LayerNorm, then the modulation in bf16), the byte bound
    (x and delta read, x' and h written, the modulations once) and the
    wrapper-paced times of the kernel, the library form and adaln_ref."""
    import torch.nn.functional as F

    from safe_denoiser_tpu_torch.ops import adaln

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)

    def library(x, scale=None, shift=None, gate=None, delta=None):
        if delta is not None:
            x = torch.addcmul(x, gate[:, None], delta)
            if scale is None:
                return x
        h = torch.addcmul(shift[:, None],
                          F.layer_norm(x, x.shape[-1:], eps=adaln.EPS),
                          1 + scale[:, None])
        return h if delta is None else (x, h)

    def composition(x, scale=None, shift=None, gate=None, delta=None):
        if delta is not None:
            x = x + gate[:, None] * delta
            if scale is None:
                return x
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        ln = ((xf - mean) * torch.rsqrt(var + adaln.EPS)).to(x.dtype)
        h = ln * (1 + scale[:, None]) + shift[:, None]
        return h if delta is None else (x, h)

    res = None
    for b, s, d in ADALN_SHAPES:
        x = (torch.randn(b, s, d, device=dev, generator=g) * 2 + 0.5
             ).bfloat16()
        delta = torch.randn(b, s, d, device=dev, generator=g).bfloat16()
        mod = (torch.randn(b, 6 * d, device=dev, generator=g) * 0.5
               ).bfloat16()
        shift, scale, gate = mod.chunk(6, -1)[:3]
        for mode in ADALN_MODES:
            kw = {"norm": dict(scale=scale, shift=shift),
                  "residual+norm": dict(scale=scale, shift=shift, gate=gate,
                                        delta=delta),
                  "residual": dict(gate=gate, delta=delta)}[mode]

            def kernel():
                return adaln.adaln(x, **kw)

            def plain_fn():
                return adaln.adaln_ref(x, **kw)

            def lib_fn():
                return library(x, **kw)

            def eager():
                return composition(x, **kw)

            def outs(r):
                return r if isinstance(r, tuple) else (r,)

            got, want, lib = outs(kernel()), outs(plain_fn()), outs(lib_fn())
            torch.cuda.synchronize()
            if mode != "norm" and not torch.equal(got[0], want[0]):
                fail(f"adaln {mode} [{b},{s},{d}]: x' differs from "
                     f"adaln_ref's")
            err = (got[-1].float() - want[-1].float()).abs().max().item()
            lib_err = (lib[-1].float() - want[-1].float()).abs().max().item()
            # one bf16 ulp of max|h| (sums in another order, rsqrtf)
            tol = 2.0 ** (math.floor(math.log2(
                want[-1].float().abs().max().item())) - 7)
            # [b, s, d] streams and [b, d] modulations read or written
            streams, vecs = {"norm": (2, 2), "residual+norm": (4, 3),
                             "residual": (3, 1)}[mode]
            bnd = bound_ms((streams * b * s + vecs * b) * d * 2, 0,
                           PEAK_BF16)
            dtm = (device_ms(kernel), device_ms(lib_fn))
            ms, plain = cuda_ms(kernel), cuda_ms(plain_fn)
            _report("adaln", [b, s, d, mode], err, tol, ms, plain,
                    cuda_ms(lib_fn), bnd,
                    "library: F.layer_norm + torch.addcmul", dtm)
            print(f"kernel adaln {[b, s, d, mode]}: library max|d| against "
                  f"adaln_ref={lib_err:.3e}; eager composition "
                  f"device_ms={device_ms(eager):.4f}; kernel / library "
                  f"device time={dtm[0] / dtm[1]:.3f}")
            if res is None:
                res = dict(err=err, ms=ms, plain=plain, lib=None, bound=bnd,
                           dev=(dtm[0], None))
            res["err"] = max(res["err"], err)
    return {"adaln": res}


def phase_backward_kernels() -> dict:
    """Each backward kernel against its plain backward on the same inputs
    (the plain one in f32) at the training slice's shapes, with its device
    time, a library call's (the autograd backward of the PyTorch call that
    computes the forward: events around the call, as its autograd graph is
    not captured), the plain version's and the bound."""
    import torch.nn.functional as F

    from safe_denoiser_tpu_torch.ops import attention, conv3x3, group_norm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    results = {}

    def keep(name, row):
        if name not in results:
            results[name] = row
        results[name]["err"] = max(results[name]["err"], row["err"])

    # B1b: q, k, v, dO ~ N(0, 1) in bf16, O from B1; plain from the same
    # bf16 values in f32. B1's forward under autograd keeps each row's
    # logsumexp (its output the no-grad one bit for bit), which the timed
    # calls read, as training does. Library: SDPA's backward (flash) on
    # the [B, H, S, D] views, wrapper-paced as the autograd call and, on
    # the device, aten's flash backward alone on the flash forward's
    # logsumexp
    for b, s, h, d in BWD_B1:
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=g)
                       .to(torch.bfloat16) for _ in range(4))
        scale = d ** -0.5
        o = attention.self_attention(q, k, v, scale)
        o_lse, lse = attention._self_attention_cuda(q, k, v, scale,
                                                    with_lse=True)
        if not torch.equal(o_lse, o):
            fail(f"attention {[b, s, h, d]}: the forward that keeps the "
                 "logsumexp changed the output")
        lse_err = (lse - attention.attention_lse_ref(q, k, scale)
                   ).abs().max().item()
        print(f"kernel attention {[b, s, h, d]}: logsumexp max|d|="
              f"{lse_err:.3e} tol={LSE_ATOL:.1e}, output bit for bit the "
              "no-grad one")
        if not lse_err <= LSE_ATOL:
            fail(f"attention {[b, s, h, d]}: logsumexp max|d| {lse_err:.3e}"
                 f" above {LSE_ATOL:.1e}")
        got = attention._attention_bwd_cuda(q, k, v, o, do, scale)
        want = attention.attention_bwd_ref(*(t.float() for t in
                                             (q, k, v, o, do)), scale)
        err = max(_rel_err(x, y) for x, y in zip(got, want))

        def kernel():
            return attention._attention_bwd_cuda(q, k, v, o, do, scale, lse)

        if not all(torch.equal(x, y) for x, y in zip(kernel(), got)):
            fail(f"attention_bwd {[b, s, h, d]}: the call on the kept "
                 "logsumexp differs from the call that recomputes it")
        del got, want, o_lse

        ms = cuda_ms(kernel, reps=5)
        plain = cuda_ms(lambda: attention.attention_bwd_ref(
            q, k, v, o, do, scale), reps=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), reps=5)
        fo = torch.ops.aten._scaled_dot_product_flash_attention(
            *(t.detach() for t in (qt, kt, vt)), scale=scale)

        def flash_bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, *(t.detach() for t in (qt, kt, vt)), fo[0], fo[1],
                fo[2], fo[3], fo[4], fo[5], 0.0, False, fo[6], fo[7],
                scale=scale)

        dtm = (device_ms(kernel, reps=5), device_ms(flash_bwd, reps=5))
        bnd = bound_ms(8 * b * s * h * d * 2, attention.bwd_flops(b, s, h, d),
                       PEAK_BF16)
        _report("attention_bwd", [b, s, h, d], err, BWD_B1_RTOL, ms, plain,
                lib, bnd, "autograd of F.scaled_dot_product_attention; "
                "library_device_ms: aten's flash backward alone", dtm,
                metric="max|d|/max|plain|")
        print(f"kernel attention_bwd {[b, s, h, d]}: "
              f"{dtm[0] / dtm[1]:.2f}x the flash backward's device time")
        del qt, kt, vt, ot, fo
        keep("attention_bwd", dict(err=err, ms=ms, plain=plain, lib=lib,
                                   bound=bnd, dev=dtm))

    # B5b: x ~ N(1, 2^2) in bf16, ds1/ds2 ~ N(0, 1) f32; the kernel's bf16
    # dx against the plain one in f32, within one bf16 ulp of max|dx|.
    # Library: the expression ds1 + 2 x ds2 (f32 out). Bound: one read of
    # x, one write of dx
    for b, s, c in BWD_B5:
        x = (torch.randn(b, s, c, device=dev, generator=g) * 2 + 1).to(
            torch.bfloat16)
        ds1, ds2 = (torch.randn(b, c, device=dev, generator=g)
                    for _ in range(2))
        got = group_norm._gn_stats_bwd_cuda(x, ds1, ds2)
        want = group_norm.gn_stats_bwd_ref(x.float(), ds1, ds2)
        err = (got.float() - want).abs().max().item()
        tol = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
        ms = cuda_ms(lambda: group_norm._gn_stats_bwd_cuda(x, ds1, ds2))
        plain = cuda_ms(lambda: group_norm.gn_stats_bwd_ref(x, ds1, ds2))

        def library():
            return ds1[:, None] + 2 * x * ds2[:, None]

        lib = cuda_ms(library)
        dtm = (device_ms(lambda: group_norm._gn_stats_bwd_cuda(x, ds1, ds2)),
               device_ms(library))
        bnd = bound_ms(2 * x.nbytes + 2 * b * c * 4, 0, PEAK_F32)
        _report("gn_stats_bwd", [b, s, c], err, tol, ms, plain, lib, bnd,
                "ds1[:, None] + 2 * x * ds2[:, None]", dtm)
        keep("gn_stats_bwd", dict(err=err, ms=ms, plain=plain, lib=lib,
                                  bound=bnd, dev=dtm))

    # B3b: h, dy ~ N(0, 1) bf16, w ~ N(0, 1/(9 Ci)) bf16; plain in f32
    # (TF32 off). Library: cuDNN's convolution_backward on the upsampled
    # channels_last input, dgrad (without the 2x2 pool) for dx, wgrad +
    # bias for dw
    for b, h2, w2, ci, co in BWD_B3:
        hh = torch.randn(b, h2, w2, ci, device=dev, generator=g).to(
            torch.bfloat16)
        w = (torch.randn(co, ci, 3, 3, device=dev, generator=g)
             / (9 * ci) ** 0.5).to(torch.bfloat16)
        dy = torch.randn(b, 2 * h2, 2 * w2, co, device=dev,
                         generator=g).to(torch.bfloat16)
        w4 = conv3x3._bwd_dx_fold_cuda(w)
        if not torch.equal(w4.view(torch.int16),
                           conv3x3.bwd_dx_weights(w).view(torch.int16)):
            fail("B3b-dx's fold pass differs from bwd_dx_weights")
        dh = conv3x3._conv3x3_up_bwd_dx_cuda(dy, w, hh.shape)
        dw, db = conv3x3._conv3x3_up_bwd_dw_cuda(dy, hh)
        want = conv3x3.conv3x3_up_bwd_ref(hh.float(), w.float(), dy.float())
        err_dx = _rel_err(dh, want[0])
        err_dw = max(_rel_err(dw, want[1]), _rel_err(db, want[2]))
        x_up = F.interpolate(hh.permute(0, 3, 1, 2), scale_factor=2,
                             mode="nearest").contiguous(
            memory_format=torch.channels_last)
        dyn = dy.permute(0, 3, 1, 2)
        wl = w.contiguous(memory_format=torch.channels_last)
        flops = conv3x3.flops(b, h2, w2, ci, co)
        n_h, n_y, n_w = hh.numel() * 2, dy.numel() * 2, w.numel() * 2
        for name, err, tol, fn, mask, bytes_, plain_fn in (
                ("conv3x3_up_bwd_dx", err_dx, BWD_DX_RTOL,
                 lambda: conv3x3._conv3x3_up_bwd_dx_cuda(dy, w, hh.shape),
                 [True, False, False], n_y + n_w + n_h,
                 lambda: conv3x3.conv3x3_up_bwd_ref(hh, w, dy)[0]),
                ("conv3x3_up_bwd_dw", err_dw, BWD_DW_RTOL,
                 lambda: conv3x3._conv3x3_up_bwd_dw_cuda(dy, hh),
                 [False, True, True], n_y + n_h + 2 * n_w + 4 * co,
                 lambda: conv3x3.conv3x3_up_bwd_ref(hh, w, dy)[1:])):
            def library(mask=mask):
                return torch.ops.aten.convolution_backward(
                    dyn, x_up, wl, [co], [1, 1], [1, 1], [1, 1], False,
                    [0, 0], 1, mask)

            ms = cuda_ms(fn)
            plain = cuda_ms(plain_fn, reps=2, warmup=1)
            lib = cuda_ms(library)
            dtm = (device_ms(fn), device_ms(library))
            bnd = bound_ms(bytes_, flops, PEAK_BF16)
            _report(name, [b, h2, w2, ci, co], err, tol, ms, plain, lib, bnd,
                    "aten.convolution_backward (cuDNN) on the upsampled "
                    f"input, output_mask {mask}", dtm,
                    metric="max|d|/max|plain|")
            if name == "conv3x3_up_bwd_dx":
                # the weight fold, the first of B3b-dx's two launches (its
                # plain version, bwd_dx_weights, as torch ops on the card),
                # and the plan the conv took
                tn, split = conv3x3.dx_plan(b, h2, w2, ci, co)
                fold = device_ms(lambda: conv3x3._bwd_dx_fold_cuda(w))
                fold_plain = device_ms(lambda: conv3x3.bwd_dx_weights(w))
                print(f"kernel conv3x3_up_bwd_dx {[b, h2, w2, ci, co]}: "
                      f"fold pass device_ms={fold:.4f} (bit for bit "
                      f"bwd_dx_weights, {fold_plain:.4f} as torch ops); "
                      f"plan: {tn} input channels a block, {split} blocks "
                      "a tile")
                dx_sweep([b, h2, w2, ci, co], dy, w4, hh)
            keep(name, dict(err=err, ms=ms, plain=plain, lib=lib, bound=bnd,
                            dev=dtm))
        del x_up, want, dh, dw
    # two calls give the same bits (no atomics)
    for name, fn in (("attention_bwd", lambda: attention._attention_bwd_cuda(
            q, k, v, o, do, d ** -0.5)),
            ("conv3x3_up_bwd_dx", lambda: (conv3x3._conv3x3_up_bwd_dx_cuda(
                dy, w, hh.shape),)),
            ("conv3x3_up_bwd_dw", lambda: conv3x3._conv3x3_up_bwd_dw_cuda(
                dy, hh))):
        one, two = fn(), fn()
        if not all(torch.equal(x, y) for x, y in zip(one, two)):
            fail(f"{name}: two calls on the same inputs differ")
    print("backward kernels: two calls of B1b, of B3b-dx and of B3b-dw gave "
          "the same bits")
    return results


# phase 3b's shapes: B1 (B, S, H, D) at SD-v1's two self-attentions (batch
# 4 with CFG) and SD3's joint attention; B9 (BH, S, D, valid_kv) at the
# same work in the nt layout (SD3 padded to the 512 grid); B10 (B, S, H, D)
# at SD-v1's two; B4 (B, H, W, Ci, Co, residual) at the SD-v1 decoder's
# three largest convs; B3 (B, H2, W2, Ci, Co) at the UNet's upsample and the
# SD-v1 decoder's two largest
PARENT_B1 = ((8, 4096, 8, 40), (8, 1024, 8, 80), (2, 4429, 24, 64))
PARENT_B9 = ((48, 4608, 64, 4429), (64, 4096, 40, 4096), (64, 1024, 80, 1024))
PARENT_B10 = ((8, 4096, 8, 40), (8, 1024, 8, 80))
PARENT_B4 = ((4, 64, 64, 512, 512, False), (4, 256, 256, 512, 256, False),
             (4, 512, 512, 128, 128, True))
PARENT_B3 = ((8, 32, 32, 640, 640), (4, 128, 128, 512, 512),
             (4, 256, 256, 256, 256))
PARENT_ENTRIES = {"attention": ("sdt_self_attention_bf16",),
                  "attention_nt": ("sdt_attention_nt_bf16",),
                  "attention_bshd": ("sdt_attention_bshd_bf16",),
                  "conv3x3": ("sdt_conv3x3_bf16",),
                  "conv3x3_up": ("sdt_conv3x3_up_bf16",),
                  "attention_i8": ("sdt_self_attention_i8_bf16",),
                  "conv3x3_up_interleave": (
                      "sdt_conv3x3_up_interleave_bf16",),
                  "rbf": ("sdt_rbf_score_f32",),
                  "group_norm": ("sdt_group_norm_fused",),
                  "attention_bwd": ("sdt_attention_bwd_bf16",),
                  "conv3x3_up_bwd": ("sdt_conv3x3_up_bwd_dx_bf16",
                                     "sdt_conv3x3_up_bwd_dw_bf16")}
# entries whose arguments changed since the checkout that 3b is run
# against (this one's parent), by entry: the parent's argument list.
# B3b-dw took an f32 partials scratch and its position split (dy, h, part,
# dw, db, B, H, W, Ci, Co, nsplit, chunk, stream).
PARENT_ARGTYPES = {
    "sdt_conv3x3_up_bwd_dw_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_void_p]}


def parent_dw_split(bsz: int, h2: int, w2: int, ci: int, co: int) -> tuple:
    """(nsplit, chunk) of the parent's B3b-dw (its ``dw_split``): the
    B*H2*W2 positions in runs of ``chunk`` (a multiple of 32) so that
    16 x tiles x nsplit blocks fill 264 slots."""
    m = bsz * h2 * w2
    blocks = 16 * (ci // 64) * (co // 64)
    want = max(1, min(-(-m // 32), -(-264 // blocks)))
    chunk = -(-(-(-m // want)) // 32) * 32
    return -(-m // chunk), chunk


def build_parent(root: str) -> dict:
    """The C entry points of PARENT_ENTRIES from the checkout at ``root``
    (those whose source it has), by entry name, built (all sources at once)
    with this checkout's nvcc flags into build/torch_kernels_parent/; they
    take the arguments of this checkout's, or those of PARENT_ARGTYPES."""
    from safe_denoiser_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR.parent / "torch_kernels_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PARENT_ENTRIES:
        src = os.path.join(root, "safe_denoiser_tpu_torch", "csrc",
                           f"{name}.cu")
        if not os.path.exists(src):
            continue
        lib = str(out_dir / f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            fail(f"nvcc failed for the parent's {name}.cu:\n{err}")
        loaded = ctypes.CDLL(lib)
        for entry in PARENT_ENTRIES[name]:
            fn = getattr(loaded, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = PARENT_ARGTYPES.get(
                entry, _build.SIGNATURES[name][entry])
            fns[entry] = fn
    return fns


def load_parent_group_norm(root: str):
    """The checkout's ``ops/group_norm.py`` as a module of its own, loaded
    by path: B6 in Triton, before ``csrc/group_norm.cu`` (the module then
    imported only functools, os and torch)."""
    import importlib.util

    path = os.path.join(root, "safe_denoiser_tpu_torch", "ops",
                        "group_norm.py")
    spec = importlib.util.spec_from_file_location("parent_group_norm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_parent(root: str) -> None:
    """Phase 3b: B1, B1b, B3b-dx, B3b-dw, B9, B10, B4, B3, B8, B7, B2 and B6
    of the checkout at ``root`` against this checkout's on the same seeded
    inputs, device times (``device_ms``) in turns (parent, this, this,
    parent), with the largest difference of their outputs."""
    from safe_denoiser_tpu_torch.models import SD3_VAE
    from safe_denoiser_tpu_torch.ops import (
        _build, attention, conv3x3, group_norm, repellency_kernels)

    parent = build_parent(root)
    this = {entry: getattr(_build.library(name), entry)
            for name, entries in PARENT_ENTRIES.items()
            for entry in entries if entry in parent}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def turns(name, call, shape, fns=None, entry=None):
        """``call(fn)`` with the parent's and this checkout's ``entry``
        (by default the one entry of library ``name``), or the two
        callables of ``fns``."""
        entry = entry or PARENT_ENTRIES.get(name, (None,))[0]
        fns = fns or {"parent": parent[entry], "this": this[entry]}
        diff = (call(fns["this"]).float()
                - call(fns["parent"]).float()).abs().max().item()
        ms = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            ms[who].append(device_ms(lambda: call(fns[who]), reps=20))
        print(f"parent {name} {shape}: parent_ms="
              f"{ms['parent'][0]:.4f}/{ms['parent'][1]:.4f} this_ms="
              f"{ms['this'][0]:.4f}/{ms['this'][1]:.4f} "
              f"max|this-parent|={diff:.3e}")

    for b, s, h, d in PARENT_B1:
        q, k, v = (torch.randn(b, s, h, d, device=dev, generator=g)
                   .bfloat16() for _ in range(3))

        def attn(fn):
            out = torch.empty_like(q)
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), b, s, h, d, *q.stride()[:3],
                            d ** -0.5, _build.stream_ptr(dev)),
                         "sdt_self_attention_bf16")
            return out

        turns("attention", attn, [b, s, h, d])
    # B1b at phase 3's shapes, on the logsumexp B1's forward keeps
    for b, s, h, d in BWD_B1:
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=g)
                       .bfloat16() for _ in range(4))
        o, lse = attention._self_attention_cuda(q, k, v, d ** -0.5,
                                                with_lse=True)
        sp = attention.lse_pitch(s)
        stats = torch.empty((2, b * h * sp), dtype=torch.float32, device=dev)

        def attn_bwd(fn):
            grads = [torch.empty_like(q) for _ in range(3)]
            ptrs = [t.data_ptr() for t in (q, k, v, o, do, *grads)]
            _build.check(fn(*ptrs, lse.data_ptr(), stats[1].data_ptr(), b,
                            s, h, d, sp, d ** -0.5, _build.stream_ptr(dev)),
                         "sdt_attention_bwd_bf16")
            return torch.cat([t.flatten() for t in grads])

        turns("attention_bwd", attn_bwd, [b, s, h, d])
        del q, k, v, do, o, lse, stats
    # B3b-dx and B3b-dw at phase 3's shape, each entry on its own list
    # where PARENT_ARGTYPES has the parent's (dw's time: all its launches)
    dx_entry, dw_entry = PARENT_ENTRIES["conv3x3_up_bwd"]
    for b, h2, w2, ci, co in BWD_B3:
        hh = torch.randn(b, h2, w2, ci, device=dev, generator=g).bfloat16()
        w = (torch.randn(co, ci, 3, 3, device=dev, generator=g)
             / (9 * ci) ** 0.5).bfloat16()
        dy = torch.randn(b, 2 * h2, 2 * w2, co, device=dev,
                         generator=g).bfloat16()
        w4 = conv3x3.bwd_dx_weights(w)

        def old(fn, entry):
            return fn is parent.get(entry) and entry in PARENT_ARGTYPES

        def up_dx(fn):
            dh = torch.empty_like(hh)
            _build.check(fn(dy.data_ptr(), w4.data_ptr(), dh.data_ptr(), b,
                            h2, w2, ci, co, _build.stream_ptr(dev)),
                         dx_entry)
            return dh

        def up_dw(fn):
            out = torch.empty(co * ci * 9 + co, device=dev)  # dW, then db
            dw, db = out[:co * ci * 9], out[co * ci * 9:]
            if old(fn, dw_entry):
                nsplit, chunk = parent_dw_split(b, h2, w2, ci, co)
                part = torch.empty(nsplit * 16 * co * ci, device=dev)
                args = (dy.data_ptr(), hh.data_ptr(), part.data_ptr(),
                        dw.data_ptr(), db.data_ptr(), b, h2, w2, ci, co,
                        nsplit, chunk)
            else:
                args = (dy.data_ptr(), hh.data_ptr(), dw.data_ptr(),
                        db.data_ptr(), b, h2, w2, ci, co)
            _build.check(fn(*args, _build.stream_ptr(dev)), dw_entry)
            return out

        if dx_entry in parent:
            turns("conv3x3_up_bwd_dx", up_dx, [b, h2, w2, ci, co],
                  entry=dx_entry)
            turns("conv3x3_up_bwd_dw", up_dw, [b, h2, w2, ci, co],
                  entry=dw_entry)
        del hh, w, dy, w4
    for bh, s, d, valid in PARENT_B9:
        q, k, v = (torch.randn(bh, s, d, device=dev, generator=g)
                   for _ in range(3))
        k[:, valid:] = 0
        v[:, valid:] = 0
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()

        def attn_nt(fn):
            out = torch.empty_like(q)
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), bh, s, d, valid, d ** -0.5,
                            _build.stream_ptr(dev)), "sdt_attention_nt_bf16")
            return out

        turns("attention_nt", attn_nt, [bh, s, d, f"valid_kv={valid}"])
    for b, s, h, d in PARENT_B10:
        q, k, v = (torch.randn(b, s, h, d, device=dev, generator=g)
                   .bfloat16() for _ in range(3))

        def attn_bshd(fn):
            out = torch.empty_like(q)
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), b, s, h, d, d ** -0.5,
                            _build.stream_ptr(dev)),
                         "sdt_attention_bshd_bf16")
            return out

        turns("attention_bshd", attn_bshd, [b, s, h, d])
    for b, h, w, ci, co, with_res in PARENT_B4:
        x = torch.randn(b, h, w, ci, device=dev, generator=g).bfloat16()
        wt, bias = conv3x3.pack_weights_3x3(
            torch.randn(co, ci, 3, 3, device=dev, generator=g)
            / (9 * ci) ** 0.5,
            0.1 * torch.randn(co, device=dev, generator=g))
        a = (1.0 + 0.2 * torch.randn(b, ci, device=dev, generator=g)
             ).bfloat16()
        sh = (0.5 * torch.randn(b, ci, device=dev, generator=g)).bfloat16()
        res = (torch.randn(b, h, w, co, device=dev, generator=g).bfloat16()
               if with_res else None)

        def conv(fn):
            out = torch.empty((b, h, w, co), dtype=x.dtype, device=dev)
            _build.check(fn(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                            a.data_ptr(), sh.data_ptr(),
                            None if res is None else res.data_ptr(),
                            out.data_ptr(), b, h, w, ci, co, 1,
                            _build.stream_ptr(dev)), "sdt_conv3x3_bf16")
            return out

        turns("conv3x3", conv, [b, h, w, ci, co] + (["+res"] if with_res
                                                     else []))
    for b, h2, w2, ci, co in PARENT_B3:
        hh = torch.randn(b, h2, w2, ci, device=dev, generator=g).bfloat16()
        wt, bias = conv3x3.pack_weights(
            torch.randn(co, ci, 3, 3, device=dev, generator=g)
            / (9 * ci) ** 0.5, torch.randn(co, device=dev, generator=g))

        def up(fn):
            out = torch.empty((b, 2 * h2, 2 * w2, co), dtype=hh.dtype,
                              device=dev)
            _build.check(fn(hh.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), b, h2, w2, ci, co,
                            _build.stream_ptr(dev)), "sdt_conv3x3_up_bf16")
            return out

        turns("conv3x3_up", up, [b, h2, w2, ci, co])
        del hh
    # B8 at its phase-3 shapes
    for b, s, h, d in B8_ATOL:
        q, k, v = (torch.randn(b, s, h, d, device=dev, generator=g)
                   .bfloat16() for _ in range(3))
        cq, ck = attention.i8_dequant_scales(d ** -0.5)
        qi = torch.empty(2, b * h * s * attention.i8_width(d),
                         dtype=torch.int8, device=dev)
        deq = torch.empty(2 * b * h * attention.i8_pitch(s),
                          dtype=torch.float32, device=dev)

        def attn_i8(fn):
            out = torch.empty_like(q)
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), qi[0].data_ptr(),
                            qi[1].data_ptr(), deq.data_ptr(), b, s, h, d,
                            *q.stride()[:3], cq, ck, _build.stream_ptr(dev)),
                         "sdt_self_attention_i8_bf16")
            return out

        turns("attention_i8", attn_i8, [b, s, h, d])
        del q, k, v, qi, deq
    # B7 at its phase-3 shapes: the SD-v1 and SD3 decoders' upsamples
    sd3 = vae_kernel_plan(SD3_VAE, 1, SD3_SIDE // 8, SD3_SIDE // 8)[1]
    for b, h2, w2, c in ((4, 64, 64, 512), (4, 128, 128, 512),
                         (4, 256, 256, 256), *sd3["conv3x3_up"]):
        hh = torch.randn(b, h2, w2, c, device=dev, generator=g).bfloat16()
        wt, bias = conv3x3.pack_weights(
            torch.randn(c, c, 3, 3, device=dev, generator=g)
            / (9 * c) ** 0.5, torch.randn(c, device=dev, generator=g))

        def up_il(fn):
            out = torch.empty((b, 2 * h2, 2 * w2, c), dtype=hh.dtype,
                              device=dev)
            _build.check(fn(hh.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), b, h2, w2, c, c,
                            _build.stream_ptr(dev)),
                         "sdt_conv3x3_up_interleave_bf16")
            return out

        turns("conv3x3_up_interleave", up_il, [b, h2, w2, c, c])
        del hh
    # B2 at its phase-3 shapes (the parent's entry without a plan where
    # PARENT_ARGTYPES has its old argument list)
    for n, m, cc, hw in ((4, 515, 4, 64), (1, 16, 16, 128)):
        dd = cc * hw * hw
        refs = torch.randn(m, dd, device=dev, generator=g)
        x = refs[:n] + 0.1 * torch.randn(n, dd, device=dev, generator=g)
        w = torch.empty((n, m), device=dev)
        beta = torch.empty((n,), device=dev)
        p = repellency_kernels.rbf_plan(n, m, dd, 4)

        def rbf(fn):
            num = torch.empty((n, dd), device=dev)
            old = (fn is parent["sdt_rbf_score_f32"]
                   and "sdt_rbf_score_f32" in PARENT_ARGTYPES)
            plan = [] if old else list(p)
            _build.check(fn(x.data_ptr(), refs.data_ptr(), w.data_ptr(),
                            num.data_ptr(), beta.data_ptr(), n, m, dd,
                            2 * 3.15 ** 2, 1e-8, 1, *plan,
                            _build.stream_ptr(dev)), "sdt_rbf_score_f32")
            return num

        turns("rbf", rbf, [n, dd, m])
        del refs, x
    # B6 at its phase-3 shapes: the parent's C entry on this checkout's
    # plan, or its Triton kernels, loaded by path, where it has no
    # csrc/group_norm.cu
    parent_gn = (None if "sdt_group_norm_fused" in parent
                 else load_parent_group_norm(root))
    for b, s, c, dtype in GN_SHAPES:
        xx = (torch.randn(b, s, c, device=dev, generator=g) * 2 + 1).to(dtype)
        sc = 1 + 0.2 * torch.randn(c, device=dev, generator=g)
        bi = 0.5 * torch.randn(c, device=dev, generator=g)
        p = group_norm.gn_plan(b, s, c, 32, xx.element_size())

        def gn_c(fn):
            y = torch.empty_like(xx)
            _build.check(fn(xx.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                            y.data_ptr(), group_norm._GN_DTYPES[dtype], b,
                            s, c, 32, p.ct, p.cl, p.rows, p.pass_rows, p.vb,
                            int(p.resident), 1e-5, 1,
                            int(group_norm.fast_act_ok(dtype)),
                            _build.stream_ptr(dev)), "sdt_group_norm_fused")
            return y

        if parent_gn is None:
            turns("group_norm", gn_c, [b, s, c, str(dtype)[6:]])
        else:
            turns("gn_fused", lambda fn: fn(xx, sc, bi, 32, 1e-5, "silu"),
                  [b, s, c, str(dtype)[6:]],
                  {"parent": parent_gn.group_norm_fused,
                   "this": group_norm.group_norm_fused})


KERNEL_META = {
    "attention": ("cuda", "safe_denoiser_tpu_torch/csrc/attention.cu",
                  "safe_denoiser_tpu/ops/attention.py:36"),
    "attention_i8": ("cuda", "safe_denoiser_tpu_torch/csrc/attention_i8.cu",
                     "safe_denoiser_tpu/ops/attention.py:36"),
    "attention_nt": ("cuda", "safe_denoiser_tpu_torch/csrc/attention_nt.cu",
                     "safe_denoiser_tpu/ops/attention.py:177"),
    "attention_bshd": ("cuda",
                       "safe_denoiser_tpu_torch/csrc/attention_bshd.cu",
                       "safe_denoiser_tpu/ops/attention.py:262"),
    "repack_to_heads": ("cuda",
                        "safe_denoiser_tpu_torch/csrc/repack_heads.cu",
                        "safe_denoiser_tpu/ops/attention.py:367"),
    "repack_from_heads": ("cuda",
                          "safe_denoiser_tpu_torch/csrc/repack_heads.cu",
                          "safe_denoiser_tpu/ops/attention.py:376"),
    "rbf": ("cuda", "safe_denoiser_tpu_torch/csrc/rbf.cu",
            "safe_denoiser_tpu/ops/repellency_kernels.py:79"),
    "conv3x3_up": ("cuda", "safe_denoiser_tpu_torch/csrc/conv3x3_up.cu",
                   "safe_denoiser_tpu/ops/conv3x3.py:282"),
    "conv3x3": ("cuda", "safe_denoiser_tpu_torch/csrc/conv3x3.cu",
                "safe_denoiser_tpu/ops/conv3x3.py:52"),
    "gn_stats": ("triton", "safe_denoiser_tpu_torch/ops/group_norm.py",
                 "safe_denoiser_tpu/ops/group_norm.py:138"),
    "conv3x3_up_interleave": (
        "cuda", "safe_denoiser_tpu_torch/csrc/conv3x3_up_interleave.cu",
        "safe_denoiser_tpu/ops/conv3x3.py:180"),
    "gn_fused": ("cuda", "safe_denoiser_tpu_torch/csrc/group_norm.cu",
                 "safe_denoiser_tpu/ops/group_norm.py:181"),
    # the backward kernels: no TPU kernel of their own (the JAX kernels have
    # no VJP); "replaces" names the TPU kernel whose function they
    # differentiate, and "backward" marks them
    "attention_bwd": ("cuda", "safe_denoiser_tpu_torch/csrc/attention_bwd.cu",
                      "safe_denoiser_tpu/ops/attention.py:36"),
    "gn_stats_bwd": ("triton", "safe_denoiser_tpu_torch/ops/group_norm.py",
                     "safe_denoiser_tpu/ops/group_norm.py:138"),
    "conv3x3_up_bwd_dx": ("cuda",
                          "safe_denoiser_tpu_torch/csrc/conv3x3_up_bwd.cu",
                          "safe_denoiser_tpu/ops/conv3x3.py:282"),
    "conv3x3_up_bwd_dw": ("cuda",
                          "safe_denoiser_tpu_torch/csrc/conv3x3_up_bwd.cu",
                          "safe_denoiser_tpu/ops/conv3x3.py:282"),
    # the port's own: no TPU kernel (XLA fuses what it computes)
    "adaln": ("cuda", "safe_denoiser_tpu_torch/csrc/adaln.cu", None),
}


def kernels_line(results: dict, counts: dict) -> str:
    rows = []
    for name, (route, source, replaces) in KERNEL_META.items():
        r = results[name]
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["lib"], "device_ms": r["dev"][0],
            "library_device_ms": r["dev"][1],
            "backward": name in BWD_KERNELS,
            **({"raw_shards": r["raw_shards"]} if "raw_shards" in r
               else {})})
    return json.dumps({"kernels": rows})


PROMPTS = ["a photo of a cat on a sofa", "a dog runs on the beach",
           "a portrait of a woman in a garden", "a city street at night"]


def write_tiny_vocab(path: str) -> None:
    """A small BPE vocabulary in HF layout (vocab.json + merges.txt): the
    256 byte symbols, their end-of-word forms, a few merges and the two
    specials. Real CLIP vocabularies are not in the repository."""
    from safe_denoiser_tpu_torch.text.clip_tokenizer import bytes_to_unicode
    chars = list(bytes_to_unicode().values())
    tokens = chars + [c + "</w>" for c in chars]
    merges = [("c", "a"), ("t", "</w>"), ("ca", "t</w>"), ("d", "o"),
              ("do", "g</w>"), ("o", "n</w>"), ("a", "</w>")]
    tokens += ["".join(m) for m in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))


def copy_vocab(vocab_src: str, dst: str) -> None:
    """``write_tiny_vocab``'s two files into a new tokenizer dir."""
    os.makedirs(dst)
    for name in ("vocab.json", "merges.txt"):
        with open(os.path.join(vocab_src, name)) as f, \
                open(os.path.join(dst, name), "w") as g:
            g.write(f.read())


def build_random_pipeline(device, vocab_dir: str, unet_cfg=None,
                          vae_cfg=None, clip_cfg=None, seed: int = 0,
                          dtype=torch.bfloat16):
    """SafeDiffusionPipeline with weights drawn from ``seed`` (PyTorch's
    default initializers), SD-v1.4 widths unless configs are given. The
    modules are created on ``device`` directly."""
    import dataclasses

    from safe_denoiser_tpu_torch.models import (
        CLIP_VIT_L_14, SD14_UNET, SD14_VAE, AutoencoderKL, CLIPTextModel,
        UNet2DConditionModel)
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    from safe_denoiser_tpu_torch.schedulers import DDPMScheduler
    from safe_denoiser_tpu_torch.text import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(vocab_dir)
    clip_cfg = dataclasses.replace(clip_cfg or CLIP_VIT_L_14,
                                   eos_token_id=tok.eos_token_id)
    torch.manual_seed(seed)
    with torch.device(device):
        unet = UNet2DConditionModel(unet_cfg or SD14_UNET)
        vae = AutoencoderKL(vae_cfg or SD14_VAE)
        text = CLIPTextModel(clip_cfg)
    return SafeDiffusionPipeline(unet.to(dtype), vae.to(dtype), text, tok,
                                 DDPMScheduler(), device=device)


def tiny_slice(device, vocab_dir: str, steps: int = 5, side: int = 8):
    """The whole slice at a tiny width in f32 -- tokenize, CLIP encode, the
    DDPM loop with CFG and kernel_fast repellency, VAE decode -- on
    ``device``, with weights, initial latents, noise and bank made on the
    CPU from seeds, so two devices compute the same function. ``side`` is
    the latents' height and width (32: S = 1024 tokens in the UNet's first
    level and the VAE's mid-block, so self-attention takes the kernels).
    Returns (final latents, image, rep_applied) as CPU tensors."""
    from safe_denoiser_tpu_torch.models import CLIPTextConfig, UNetConfig, \
        VAEConfig
    from safe_denoiser_tpu_torch.pipeline import (
        GuidanceConfig, RepellencyWindow, sample_sd)
    from safe_denoiser_tpu_torch.repellency import RepellencyConfig

    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline

    cpu = build_random_pipeline(
        "cpu", vocab_dir,
        UNetConfig(sample_size=side, block_out_channels=(32, 64),
                   layers_per_block=1, cross_attention_dim=32,
                   num_attention_heads=2, norm_num_groups=8),
        VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                  norm_num_groups=8),
        CLIPTextConfig(vocab_size=528, hidden_size=32, num_layers=2,
                       num_heads=2, intermediate_size=64),
        dtype=torch.float32)
    pipe = SafeDiffusionPipeline(cpu.unet, cpu.vae, cpu.text_encoder,
                                 cpu.tokenizer, cpu.scheduler, device=device)
    g = torch.Generator().manual_seed(1)
    b, shape = 2, (4, side, side)
    lat0 = torch.randn(b, *shape, generator=g)
    noise = torch.randn(steps, 2, b, *shape, generator=g)
    bank = torch.randn(6, *shape, generator=g)
    bank = bank / bank.norm(dim=1, keepdim=True)
    dev = pipe.device
    with torch.no_grad():
        text = torch.cat([pipe.encode_prompt(p) for p in PROMPTS[:b]], dim=1)
        lat, applied = sample_sd(
            pipe.unet, pipe.scheduler, text, lat0.to(dev),
            lambda i, salt: noise[i, salt - 1].to(dev), steps,
            guidance=GuidanceConfig(),
            repellency=RepellencyConfig(sigma=30.0, scale=0.4,
                                        beta_threshold=1e-12),
            refs=bank.to(dev), window=RepellencyWindow(1000.0, 300.0))
        image = pipe.vae.decode(lat / pipe.vae.config.scaling_factor)
    return lat.cpu(), image.float().cpu(), applied.cpu()


def phase_layouts_f32(vocab_dir: str) -> None:
    """The tiny slice at 32^2 latents, f32, under each attention layout on
    the GPU against the CPU under the same layout, within the tiny slice's
    bounds; the CPU run counts the self-attentions that the layout's
    kernels (their f32 entries) must take on the GPU."""
    from safe_denoiser_tpu_torch import ops

    for layout in LAYOUTS:
        with layout_env(layout):
            with count_self_attention() as calls:
                want = tiny_slice("cpu", vocab_dir, steps=3, side=32)
            ops.reset_launch_counts()
            got = tiny_slice("cuda", vocab_dir, steps=3, side=32)
            counts = ops.launch_counts()
        d_lat = (got[0] - want[0]).abs().max().item()
        d_img = (got[1] - want[1]).abs().max().item()
        print(f"tiny slice at 32^2, f32, layout {layout}: cuda vs cpu max|d| "
              f"latents={d_lat:.3e} image={d_img:.3e}")
        if not (d_lat <= 2e-3 and d_img <= 1e-2
                and torch.equal(got[2], want[2])):
            fail(f"tiny slice at 32^2 under {layout}: the GPU disagrees "
                 "with the CPU")
        check_launches({k: counts[k] for k in ATTN_KERNELS},
                       attention_launches(layout, calls[0]),
                       f"tiny slice at 32^2 under {layout}")


def sd14_kw(dev) -> dict:
    """The main path's batch keywords: 4 x 512^2, CFG 7.5, kernel_fast
    against a 515-row random bank in the window [1000, 780]."""
    from safe_denoiser_tpu_torch.pipeline import EraseSpec, RepellencyWindow
    from safe_denoiser_tpu_torch.repellency import KernelFastRepellency

    g = torch.Generator(device=dev).manual_seed(1)
    bank = torch.randn(515, 4, 64, 64, generator=g, device=dev)
    proc = KernelFastRepellency(ref_data=bank, embed_fn=lambda x: x,
                                sigma=3.15, scale=0.33, beta_threshold=7.0)
    spec = EraseSpec(repellency=True, window=RepellencyWindow(1000.0, 780.0))
    return dict(guidance_scales=[7.5] * 4, height=512, width=512,
                repellency_processor=proc, erase_spec=spec)


def phase_main_path() -> dict:
    from safe_denoiser_tpu_torch import ops

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as vocab_dir:
        write_tiny_vocab(vocab_dir)
        # reference on a small input: the tiny slice on the GPU against
        # the same slice on the CPU (plain versions), f32, TF32 off;
        # tolerance as the JAX package's loop parity (f32 sums in another
        # order, amplified over 5 steps)
        got = tiny_slice("cuda", vocab_dir)
        want = tiny_slice("cpu", vocab_dir)
        d_lat = (got[0] - want[0]).abs().max().item()
        d_img = (got[1] - want[1]).abs().max().item()
        print(f"tiny slice cuda vs cpu: max|d| latents={d_lat:.3e} "
              f"image={d_img:.3e} applied={got[2].tolist()}")
        if not (d_lat <= 2e-3 and d_img <= 1e-2
                and torch.equal(got[2], want[2]) and bool(got[2].any())):
            fail("tiny slice on the GPU disagrees with the CPU")
        phase_layouts_f32(vocab_dir)

        t0 = time.perf_counter()
        pipe = build_random_pipeline(dev, vocab_dir)
        torch.cuda.synchronize()
        print(f"main path: SD-v1.4 widths, random weights (seed 0), built in "
              f"{time.perf_counter() - t0:.1f} s")
    kw = sd14_kw(dev)
    pipe.generate_batch(PROMPTS, seeds=[0, 1, 2, 3], num_inference_steps=2,
                        **kw)                                   # warm-up
    # the first 50-step batch captures the loop's and the decode's graphs
    t0 = time.perf_counter()
    first = pipe.dispatch_batch(PROMPTS, seeds=[0, 1, 2, 3],
                                num_inference_steps=50, **kw)
    first.fetch()
    print(f"main path graphs: warm-up step and capture "
          f"{first.stage_ms['capture']:.2f} ms, first batch wall_s="
          f"{time.perf_counter() - t0:.3f}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pending = pipe.dispatch_batch(PROMPTS, seeds=[0, 1, 2, 3],
                                  num_inference_steps=50, **kw)
    images = pending.fetch()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    if not bool(torch.isfinite(pending.image).all()):
        fail("decoded images hold non-finite values")
    if len(images) != 4 or any(im.dtype.name != "uint8"
                               or im.shape != (512, 512, 3) for im in images):
        fail(f"images: {[(im.dtype, im.shape) for im in images]}")
    st = pending.stage_ms
    print(f"main path: 4 x 512^2, 50 DDPM steps, CFG 7.5, kernel_fast "
          f"window [1000,780]: encode_ms={st['encode']:.2f} "
          f"loop_ms={st['loop']:.2f} decode_ms={st['decode']:.2f} "
          f"wall_s={wall:.3f} images_per_s={4 / wall:.4f} "
          f"rep_applied_steps={int(pending.applied.any(1).sum())}")
    print(f"main path decode: {st['decode']:.2f} ms with the fused conv "
          f"(B4) in the resnets; with cuDNN resnet convs it took "
          f"{DECODE_MS_CUDNN} ms")
    check_launches(counts, EXPECTED_LAUNCHES, "main path")
    graph_check(pipe, "sd14-main", PROMPTS, [0, 1, 2, 3],
                num_inference_steps=50, **kw)
    return counts, pipe, kw


def first_step_x0(pipe, steps: int, seeds: list) -> tuple:
    """(t, x0 [4, 4, 64, 64]) of the first of ``steps`` DDPM steps of
    PROMPTS at 512^2 with CFG 7.5, computed as the pipeline computes it:
    the same seeds give the same initial latents."""
    dev, sch, n = pipe.device, pipe.scheduler, len(PROMPTS)
    t = int(sch.timesteps(steps)[0])
    with torch.no_grad():
        text = torch.cat([pipe.encode_prompt(p) for p in PROMPTS], dim=1)
        lat = torch.stack([
            torch.randn((4, 64, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(s))
            for s in seeds]) * sch.init_noise_sigma
        eps = pipe.unet(torch.cat([lat, lat]), t,
                        text.reshape(2 * n, *text.shape[2:]))
        uncond, cond = eps.reshape(2, n, *eps.shape[1:])
        x0 = sch.pred_original_sample(uncond + 7.5 * (cond - uncond), t, lat)
    return t, x0.float()


def gate_runs(pipe, bank, scales=(0.33, 0.0), sigma: float = 3.15,
              beta_threshold: float = 7.0) -> dict:
    """{scale: (latents, applied, B2 launches)} of two 5-step batches of
    PROMPTS against ``bank`` (a tensor, saved as a torch.save cache as
    users load one, or the path of such a cache), window [1000, 780]."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.pipeline import EraseSpec, RepellencyWindow
    from safe_denoiser_tpu_torch.repellency import KernelFastRepellency

    n = len(PROMPTS)
    spec = EraseSpec(repellency=True, window=RepellencyWindow(1000.0, 780.0))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = bank if isinstance(bank, str) else os.path.join(tmp, "bank.pt")
        if not isinstance(bank, str):
            torch.save(bank.cpu(), path)
        for scale in scales:
            proc = KernelFastRepellency(
                ref_data=None, embed_fn=None, cache_proj_ref=True,
                proj_ref_path=path, sigma=sigma, scale=scale,
                beta_threshold=beta_threshold)
            ops.reset_launch_counts()
            pending = pipe.dispatch_batch(
                PROMPTS, seeds=[0, 1, 2, 3], guidance_scales=[7.5] * n,
                num_inference_steps=GATE_STEPS, height=SD14_SIDE,
                width=SD14_SIDE,
                repellency_processor=proc, erase_spec=spec)
            lat_out = pending.fetch(return_latents=True)
            out[scale] = (lat_out.float(), pending.applied.cpu(),
                          ops.launch_counts()["rbf"])
    return out


def phase_gate_open(pipe) -> tuple:
    """Full width with the beta gate open, which random weights and a
    random bank never open: the bank holds 128 copies of each prompt's own
    x0 at the first in-window step, so beta ~ 128 > 7 there. Two 5-step
    batches (t = 801, 601, ...; 801 lies in [1000, 780]) differ only in
    the repellency scale, 0.33 and 0: the gap between their latents is
    B2's score reaching them through the renoise-and-replace branch.
    Returns (the bank, the runs)."""
    dev = pipe.device
    copies, n = 128, len(PROMPTS)
    t, x0 = first_step_x0(pipe, GATE_STEPS, [0, 1, 2, 3])
    g = torch.Generator(device=dev).manual_seed(2)
    bank = torch.cat([x0.repeat_interleave(copies, 0),
                      torch.randn(515 - n * copies, 4, 64, 64, device=dev,
                                  generator=g)])
    out = gate_runs(pipe, bank)
    (lat_a, applied, rbf_n), (lat_b, _, _) = out[0.33], out[0.0]
    gap = (lat_a - lat_b).abs().max().item()
    print(f"gate check: 4 x 512^2, {GATE_STEPS} steps, bank of own x0 at "
          f"t={t}: applied per step {applied.any(1).tolist()} rbf launches "
          f"{rbf_n} max|latents(scale 0.33) - latents(scale 0)|={gap:.4e}")
    if not (bool(applied[0].all()) and not bool(applied[1:].any())
            and rbf_n == 1 and gap > 0
            and bool(torch.isfinite(lat_a).all())):
        fail("at full width the open beta gate did not carry B2's score "
             "into the latents")
    return bank, out


def phase_ddim(pipe, kw) -> dict:
    """The 10-step DDIM configuration at full SD-v1.4 width: phase 4's
    modules and repellency under a DDIMScheduler, 4 prompts, once under
    each of DDIM_LAYOUTS (6b) and once under FUSED_SWITCHES with the
    default layout (6c), each timed after a 2-step warm-up under its
    switches. Expected launches from the JAX package's gates as
    the switches stand: 10 self-attentions with S >= 512 per UNet step
    through the layout's kernels; B2 once per timestep in [1000, 780] (901
    and 801); B3 once per step (the UNet's upsample, planar under every
    switch); the decode's B3 or B7, B4 and GroupNorm kernels from
    ``vae_kernel_plan``; the UNet's B6 and B5 from ``unet_gn_launches``
    (without the switches 3 B5 a step; with them 57 B6 and 3 B5). Returns
    the launch counts of each run."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    from safe_denoiser_tpu_torch.schedulers import DDIMConfig, DDIMScheduler

    ddim = SafeDiffusionPipeline(pipe.unet, pipe.vae, pipe.text_encoder,
                                 pipe.tokenizer, DDIMScheduler(DDIMConfig()),
                                 device=pipe.device)
    window = kw["erase_spec"].window
    ts = ddim.scheduler.timesteps(DDIM_STEPS)
    n_rbf = sum(bool(window.mask(i, int(t))) for i, t in enumerate(ts))
    runs = [(layout, layout, lambda lay=layout: layout_env(lay))
            for layout in DDIM_LAYOUTS]
    runs.append(("fused-gn+interleave", "bhsd",
                 lambda: switches(FUSED_SWITCHES)))
    out, lat_bhsd = {}, None
    for label, layout, env in runs:
        with env():
            dec = vae_kernel_plan(pipe.vae.config, 4, 64, 64)[0]
            gnl = unet_gn_launches(pipe.unet.config, 64, 64)
            # warm-up: Triton compiles B5 for each new shape at its first
            # launch, which would land in the timed loop
            ddim.generate_batch(PROMPTS, seeds=[0, 1, 2, 3],
                                num_inference_steps=2, **kw)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            pending = ddim.dispatch_batch(PROMPTS, seeds=[0, 1, 2, 3],
                                          num_inference_steps=DDIM_STEPS,
                                          **kw)
            images = pending.fetch()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
        if not bool(torch.isfinite(pending.image).all()):
            fail(f"ddim {label}: decoded images hold non-finite values")
        _check_images(images, 512, f"ddim {label}")
        st = pending.stage_ms
        lat = pending.latents.float()
        lat_bhsd = lat if lat_bhsd is None else lat_bhsd
        print(f"ddim {label}: 4 x 512^2, {DDIM_STEPS} DDIM steps (t = "
              f"{int(ts[0])} ... {int(ts[-1])}), CFG 7.5, kernel_fast "
              f"[1000,780]: encode_ms={st['encode']:.2f} "
              f"loop_ms={st['loop']:.2f} decode_ms={st['decode']:.2f} "
              f"wall_s={wall:.3f} images_per_s={4 / wall:.4f} "
              f"rep_applied_steps={int(pending.applied.any(1).sum())} "
              f"max|latents|={lat.abs().max().item():.4e} max|latents - "
              f"bhsd's|={(lat - lat_bhsd).abs().max().item():.4e}")
        want = {**attention_launches(layout, 10 * DDIM_STEPS), "rbf": n_rbf,
                **dec, "conv3x3_up": DDIM_STEPS + dec["conv3x3_up"],
                "gn_stats": DDIM_STEPS * gnl["gn_stats"] + dec["gn_stats"],
                "gn_fused": DDIM_STEPS * gnl["gn_fused"] + dec["gn_fused"]}
        check_launches(counts, want, f"ddim {label}")
        out[f"ddim {label}"] = counts
    return out


class _Lines:
    """A logger that keeps the lines it is given."""

    def __init__(self):
        self.lines = []

    def log(self, msg: str) -> None:
        self.lines.append(msg)


def phase_erasure(pipe, kw) -> dict:
    """SD-v1's text-side erasure methods at full SD-v1.4 width on phase 4's
    modules, bank and repellency: 4 prompts, 512^2, 50 DDPM steps through
    ``dispatch_batch`` under the default switches, once per ERASURE_RUNS
    entry (SLD STRONG; SAFREE with its self-validation filter over the
    nudity concept space; latent re-attention with the SafeGuard filters).
    SLD and re-attention fold three branches into the UNet batch, so the
    launches per UNet call are those of the main path; B2 runs once per
    step in the erase id's window. Returns the launch counts of each run."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.models import FreeUConfig
    from safe_denoiser_tpu_torch.pipeline import ERASE_SPECS, SLD_CONFIGS
    from safe_denoiser_tpu_torch.runners.common import \
        NUDITY_NEGATIVE_PROMPT_SPACE

    ts = pipe.scheduler.timesteps(50)
    out = {}
    for label, (erase_id, sf, level, hyp) in ERASURE_RUNS.items():
        spec = ERASE_SPECS[erase_id]
        run_kw = {**kw, "erase_spec": spec, "safree_dict": sf,
                  "safe_config": SLD_CONFIGS[level] if level else None,
                  "freeu": None if hyp is None else FreeUConfig(
                      *hyp, mode="all"),
                  "negative_prompt_space": (NUDITY_NEGATIVE_PROMPT_SPACE
                                            if sf.get("safree") else None)}
        pipe.logger = _Lines()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        pending = pipe.dispatch_batch(PROMPTS, seeds=[0, 1, 2, 3],
                                      num_inference_steps=50, **run_kw)
        images = pending.fetch()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        lines, pipe.logger = pipe.logger.lines, None
        if not bool(torch.isfinite(pending.image).all()
                    and torch.isfinite(pending.latents).all()):
            fail(f"erasure {label}: non-finite latents or images")
        _check_images(images, 512, f"erasure {label}")
        st = pending.stage_ms
        safree_lines = [ln for ln in lines if "remove" in ln or "beta" in ln]
        print(f"erasure {label}: 4 x 512^2, 50 DDPM steps, CFG 7.5, "
              f"kernel_fast in [{spec.window.t_end:g},"
              f"{spec.window.t_start:g}]: encode_ms={st['encode']:.2f} "
              f"loop_ms={st['loop']:.2f} decode_ms={st['decode']:.2f} "
              f"wall_s={wall:.3f} images_per_s={4 / wall:.4f} "
              f"rep_applied_steps={int(pending.applied.any(1).sum())} "
              f"{safree_lines}")
        want = {**EXPECTED_LAUNCHES,
                "rbf": sum(bool(spec.window.mask(i, int(t)))
                           for i, t in enumerate(ts))}
        check_launches(counts, want, f"erasure {label}")
        out[f"erasure {label}"] = counts
        graph_check(pipe, f"erasure {label}", PROMPTS, [0, 1, 2, 3],
                    num_inference_steps=50, **run_kw)
        # svf's window follows each prompt's beta, which on random weights
        # (beta ~ 0.85) saturates at up_t for every prompt: the graph's
        # SAFREE mask is held again with windows that differ by prompt
        if sf.get("svf"):
            graph_check(pipe, f"erasure {label}, windows 11/8/5/2", PROMPTS,
                        [0, 1, 2, 3], windows=[11, 8, 5, 2],
                        num_inference_steps=50, **run_kw)
    return out


_ST_DTYPE = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32", torch.int64: "I64"}


def write_safetensors(path: str, tensors: dict) -> None:
    """A .safetensors file: an 8-byte header length, the JSON header with
    each tensor's dtype, shape and byte range, then the raw data."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu().reshape(-1)
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPE[t.dtype],
                        "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + n]}
        blobs.append(t)
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for t in blobs:
            f.write(t.view(torch.uint8).numpy().tobytes())


def write_checkpoint(pipe, root: str, vocab_src: str) -> None:
    """``pipe``'s modules as an HF-layout SD checkpoint: unet/, vae/ and
    text_encoder/ (safetensors in the modules' dtypes, diffusers/HF
    config.json), tokenizer/ from ``vocab_src``; no scheduler/, so the
    DDPM defaults hold."""
    import dataclasses

    u, v, t = (pipe.unet.config, pipe.vae.config,
               pipe.text_encoder.config)
    configs = {
        "unet": dict(dataclasses.asdict(u),
                     attention_head_dim=u.num_attention_heads),
        "vae": dataclasses.asdict(v),
        "text_encoder": dict(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size,
            num_hidden_layers=t.num_layers, num_attention_heads=t.num_heads,
            max_position_embeddings=t.max_position_embeddings,
            intermediate_size=t.intermediate_size, hidden_act=t.hidden_act,
            projection_dim=t.projection_dim, eos_token_id=t.eos_token_id),
    }
    weights = {"unet": "diffusion_pytorch_model.safetensors",
               "vae": "diffusion_pytorch_model.safetensors",
               "text_encoder": "model.safetensors"}
    for sub, module in (("unet", pipe.unet), ("vae", pipe.vae),
                        ("text_encoder", pipe.text_encoder)):
        os.makedirs(os.path.join(root, sub))
        write_safetensors(os.path.join(root, sub, weights[sub]),
                          module.state_dict())
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(configs[sub], f)
    copy_vocab(vocab_src, os.path.join(root, "tokenizer"))


def _pb_varint(v: int) -> bytes:
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _pb(num: int, payload, wire: int = 2) -> bytes:
    """One protobuf field: a varint (wire 0) or a length-delimited bytes
    or str payload (wire 2)."""
    key = _pb_varint((num << 3) | wire)
    if wire == 0:
        return key + _pb_varint(payload)
    if isinstance(payload, str):
        payload = payload.encode()
    return key + _pb_varint(len(payload)) + payload


def _onnx_node(op, ins, outs, attrs=b""):
    return _pb(1, b"".join(_pb(1, i) for i in ins)
               + b"".join(_pb(2, o) for o in outs) + _pb(4, op) + attrs)


def _onnx_ints(name, vals):
    return _pb(5, _pb(1, name) + b"".join(_pb(8, v, 0) for v in vals)
               + _pb(20, 7, 0))


def _onnx_int(name, val):
    return _pb(5, _pb(1, name) + _pb(3, val, 0) + _pb(20, 2, 0))


def _onnx_tensor(name, arr):
    import numpy as np
    dtype = {np.dtype("float32"): 1, np.dtype("int64"): 7}[arr.dtype]
    return _pb(5, b"".join(_pb(1, d, 0) for d in arr.shape)
               + _pb(2, dtype, 0) + _pb(8, name) + _pb(9, arr.tobytes()))


def _onnx_model(name: str, nodes, inits: dict, inp: str, outs) -> bytes:
    """An ONNX ModelProto (IR 7, opset 13) of one graph."""
    graph = (b"".join(nodes) + _pb(2, name)
             + b"".join(_onnx_tensor(k, v) for k, v in inits.items())
             + _pb(11, _pb(1, inp))
             + b"".join(_pb(12, _pb(1, o)) for o in outs))
    return (_pb(1, 7, 0) + _pb(8, _pb(1, "") + _pb(2, 13, 0))
            + _pb(7, graph))


def nudenet_like_onnx(seed: int = 0) -> bytes:
    """A small classifier with NudeNet's interface as an ONNX ModelProto:
    NHWC [N, 256, 256, 3] in [0, 1] -> Transpose -> 3x3 stride-4 Conv(8) ->
    Relu -> GlobalAveragePool -> Reshape -> MatMul + Add -> Softmax over
    [unsafe, safe]; weights from ``seed``."""
    import numpy as np

    rs = np.random.RandomState(seed)
    inits = {
        "w_conv": (rs.randn(8, 3, 3, 3) * 0.5).astype(np.float32),
        "b_conv": (rs.randn(8) * 0.1).astype(np.float32),
        "shape": np.array([0, -1], dtype=np.int64),
        "fc_w": (rs.randn(8, 2) * 0.5).astype(np.float32),
        "fc_b": np.zeros(2, dtype=np.float32),
    }
    node, ints = _onnx_node, _onnx_ints
    nodes = [
        node("Transpose", ["input_1"], ["x"], ints("perm", [0, 3, 1, 2])),
        node("Conv", ["x", "w_conv", "b_conv"], ["c"],
             ints("kernel_shape", [3, 3]) + ints("strides", [4, 4])
             + ints("pads", [1, 1, 1, 1])),
        node("Relu", ["c"], ["r"]),
        node("GlobalAveragePool", ["r"], ["gap"]),
        node("Reshape", ["gap", "shape"], ["flat"]),
        node("MatMul", ["flat", "fc_w"], ["l0"]),
        node("Add", ["l0", "fc_b"], ["logits"]),
        node("Softmax", ["logits"], ["dense_out"], _onnx_int("axis", 1)),
    ]
    return _onnx_model("nudenet_like", nodes, inits, "input_1",
                       ["dense_out"])


def write_runner_assets(pipe, tmp: str) -> dict:
    """The runner phases' shared assets under ``tmp``: phase 4's modules
    as an HF-layout checkpoint (``ckpt``) and the NudeNet-shaped ONNX gate
    (``onnx``)."""
    t0 = time.perf_counter()
    voc = os.path.join(tmp, "vocab")
    os.makedirs(voc)
    write_tiny_vocab(voc)
    ckpt = os.path.join(tmp, "ckpt")
    write_checkpoint(pipe, ckpt, voc)
    onnx = os.path.join(tmp, "nudenet.onnx")
    with open(onnx, "wb") as f:
        f.write(nudenet_like_onnx())
    print(f"runner assets: checkpoint and ONNX gate written in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"tmp": tmp, "ckpt": ckpt, "onnx": onnx}


def phase_runner(pipe, assets: dict) -> float:
    """The nudity runner on cuda at full SD-v1.4 width (phase 4's weights
    loaded back from the HF-layout checkpoint of ``assets``): the bank
    encoded through B4 and beta-calibrated, 4 cases of 50 steps, the
    NudeNet-shaped gate. Checks the output tree and every kernel's launch
    count; returns the wall seconds per case."""
    import re

    import numpy as np

    from safe_denoiser_tpu_torch.data.images import read_png, write_png
    from safe_denoiser_tpu_torch.runners.nudity import main as run_nudity
    from safe_denoiser_tpu_torch.utils.config import load_yaml

    tmp, ckpt, onnx = assets["tmp"], assets["ckpt"], assets["onnx"]
    t0 = time.perf_counter()
    bank = os.path.join(tmp, "bank", "i2p_sexual")
    os.makedirs(bank)
    rs = np.random.RandomState(3)
    for i in range(RUNNER_BANK):
        write_png(rs.randint(0, 256, (512, 512, 3), dtype=np.uint8),
                  os.path.join(bank, f"{i:03d}.png"))
    task = os.path.join(tmp, "task.yaml")
    with open(task, "w") as f:
        f.write(f"""# kernel_fast with beta calibrated from the bank
repellency:
  method: kernel_fast
  n_embed: {RUNNER_N_EMBED}
  params:
    sigma: 3.15
    scale: 0.33
    beta_threshold_margin: 1.6
    cache_proj_ref: False
    cache_noisy_ref_path_for_beta: False
data:
  name: nudity
  root: {os.path.join(tmp, "bank")}
  class_info: i2p_sexual
  size: 512
""")
    csv_path = os.path.join(tmp, "prompts.csv")
    with open(csv_path, "w") as f:
        f.write("case_number,prompt,evaluation_seed,categories\n")
        for i, p in enumerate(PROMPTS[:RUNNER_CASES]):
            f.write(f"{i},{p},{100 + i},sexual\n")
    print(f"runner: assets written in {time.perf_counter() - t0:.1f} s "
          f"({RUNNER_BANK} bank PNGs, task YAML, CSV)")

    out = os.path.join(tmp, "out")
    wall, counts, log = _run_quiet(run_nudity, [
        "--data", csv_path, "--save-dir", out, "--erase_id", "std_rep",
        "--model_dir", ckpt, "--task_config", task, "--nudenet-path", onnx,
        "--num_inference_steps", "50", "--image_length", "512",
        "--device", "cuda"])
    want = runner_launches(pipe, RUNNER_CASES, 10,
                           RUNNER_BANK // RUNNER_N_EMBED, RUNNER_N_EMBED)
    logs = open(os.path.join(out, "logs.txt")).read()
    per_case = _case_walls(out)
    beta = re.findall(r"t=1: ([0-9.e+-]+)", log)
    names = {f"{i}_sexual.png" for i in range(RUNNER_CASES)}
    listing = {d: set(os.listdir(os.path.join(out, d)))
               for d in ("all", "safe", "unsafe")}
    detect = json.load(open(os.path.join(out, "detect_dict.json")))
    cfg = load_yaml(os.path.join(out, "config.yaml"))
    img = read_png(os.path.join(out, "all", "0_sexual.png"))
    print(f"runner: {RUNNER_CASES} cases x 50 steps at 512^2, bank "
          f"{RUNNER_BANK} images: wall_s={wall:.3f} "
          f"per_case_s={[round(v, 2) for v in per_case]} "
          f"(dispatch to fetch, overlapped) calibrated beta at t=1: "
          f"{beta} unsafe={detect['unsafe']}")
    print(f"runner launches: {json.dumps(counts)} "
          f"expected {json.dumps(want)}")
    problems = []
    if listing["all"] != names:
        problems.append(f"all/ holds {sorted(listing['all'])}")
    if (listing["safe"] | listing["unsafe"] != names
            or listing["safe"] & listing["unsafe"]):
        problems.append(f"safe/ {sorted(listing['safe'])} and unsafe/ "
                        f"{sorted(listing['unsafe'])} do not split "
                        "the cases")
    if len(detect["unsafe"]) != RUNNER_CASES or len(per_case) != \
            RUNNER_CASES:
        problems.append("detect_dict.json or logs.txt miss cases")
    if img.shape != (512, 512, 3) or cfg["repellency"]["n_embed"] != \
            RUNNER_N_EMBED or "Repellency method : kernel_fast" not in logs:
        problems.append("image, config.yaml or logs.txt content")
    for name, n in want.items():
        if counts[name] != n:
            problems.append(f"kernel {name} launched {counts[name]} "
                            f"times, expected {n}")
    if problems:
        print(log[-4000:])
        fail("runner phase: " + "; ".join(problems))

    # 6d's runner run: sld_rep (window [1000, 780]: 11 steps a case) on the
    # first RUNNER_SLD_CASES cases under FUSED_SWITCHES, with the launches
    # from the gates as they stand
    out = os.path.join(tmp, "out_sld")
    n = RUNNER_SLD_CASES
    with switches(FUSED_SWITCHES):
        want = runner_launches(pipe, n, 11, RUNNER_BANK // RUNNER_N_EMBED,
                               RUNNER_N_EMBED)
        wall_sld, counts, log = _run_quiet(run_nudity, [
            "--data", csv_path, "--save-dir", out, "--erase_id", "sld_rep",
            "--model_dir", ckpt, "--task_config", task, "--nudenet-path",
            onnx, "--num_inference_steps", "50", "--image_length", "512",
            "--device", "cuda", "--valid_case_numbers", f"0,{n}"])
    logs = open(os.path.join(out, "logs.txt")).read()
    names = {f"{i}_sexual.png" for i in range(n)}
    detect = json.load(open(os.path.join(out, "detect_dict.json")))
    print(f"runner sld_rep under {json.dumps(FUSED_SWITCHES)}: {n} cases "
          f"x 50 steps at 512^2: wall_s={wall_sld:.3f} "
          f"unsafe={detect['unsafe']}")
    print(f"runner sld_rep launches: {json.dumps(counts)} expected "
          f"{json.dumps(want)}")
    problems = [f"kernel {k} launched {counts[k]} times, expected {v}"
                for k, v in want.items() if counts[k] != v]
    if set(os.listdir(os.path.join(out, "all"))) != names:
        problems.append("all/ does not hold the cases")
    if len(detect["unsafe"]) != n or "SLD safe level: WEAK" not in logs:
        problems.append("detect_dict.json or logs.txt content")
    if problems:
        print(log[-4000:])
        fail("runner sld_rep: " + "; ".join(problems))
    return wall / RUNNER_CASES


def runner_launches(pipe, cases: int, in_window: int, chunks: int = 0,
                    n_embed: int = 0, batch: int = 1) -> dict:
    """Each kernel's launches in a runner run under the default switches:
    ``cases`` dispatches of ``batch`` rows, 50 steps at 512^2 (10
    self-attentions with S >= 512 a step, B3 a step, the UNet's GroupNorm
    kernels a step, one decode of the batch each), B2 on ``in_window``
    steps of each, after a bank encode in ``chunks`` chunks of ``n_embed``
    512^2 images."""
    want = dict.fromkeys(EXPECTED_LAUNCHES, 0)
    want["attention"] = 500 * cases
    want["rbf"] = in_window * cases
    dec = vae_kernel_plan(pipe.vae.config, batch, 64, 64)[0]
    enc = (vae_kernel_plan(pipe.vae.config, n_embed, 512, 512,
                           "encoder")[0] if chunks else {})
    for k in dec:
        want[k] += cases * dec[k] + chunks * enc.get(k, 0)
    want["conv3x3_up"] += 50 * cases
    for k, v in unet_gn_launches(pipe.unet.config, 64, 64).items():
        want[k] += 50 * cases * v
    return want


def _task_yaml(path: str, config: str, params: dict, data: dict) -> dict:
    """The task config ``configs/<config>`` with ``params`` over its
    repellency parameters and ``data`` over its data section, written to
    ``path``; returns it."""
    from safe_denoiser_tpu_torch.utils.config import dump_yaml, load_yaml

    task = load_yaml(os.path.join(ROOT, "configs", config))
    task["repellency"]["params"].update(params)
    task["data"].update(data)
    with open(path, "w") as f:
        f.write(dump_yaml(task))
    return task


def _run_quiet(main, argv) -> tuple:
    """``main(argv)`` with its standard output kept; (wall seconds, the
    kernels' launch counts from zero, the output)."""
    import contextlib
    import io

    from safe_denoiser_tpu_torch import ops

    log = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, ops.launch_counts(), log.getvalue()


def _case_walls(out: str) -> list:
    import re
    logs = open(os.path.join(out, "logs.txt")).read()
    return [float(v) for v in re.findall(
        r"Wall-Clock Time for image generation \(Case#: \d+\): "
        r"([0-9.]+) seconds", logs)]


def phase_artist_sparse(pipe, assets: dict, profile: bool = False) -> dict:
    """6e: the artist runners and the SPELL configuration at full SD-v1.4
    width on the checkpoint of ``assets``.

    - ``runners.artist ann_graham``: ARTIST_SAMPLES samples x 50 steps
      with configs/ann_graham's repellency (kernel_fast, beta threshold
      1e-9, no calibration), its bank ARTIST_BANK random 512^2 PNGs encoded
      through B4 in chunks of n_embed 8; then ``runners.artist munch``, 1
      sample (Munch's negative prompt, guidance 2.0, configs/munch).
    - ``runners.nudity`` under configs/sparse_repellency/spell.yaml's
      parameters (sparse, radius 38.746, scale 1.6) against a cached
      projected bank of sd14-main's shape: SPELL_CASES cases x 50 steps;
      B2 never runs.
    - the SPELL force at full width: two 5-step batches against a bank
      of the run's own x0 (perturbed) at a radius that holds them, scale
      1.6 and 0; their latents must differ.
    - the euclidean (through B2), kernel and lsh processors' conditioning
      at full width on cuda against the same call on the CPU.
    With ``profile``, one SPELL case of 10 steps on phase 4's modules,
    profiled. Returns the launch counts of each runner run."""
    import numpy as np

    from safe_denoiser_tpu_torch.data.images import read_png, write_png
    from safe_denoiser_tpu_torch.runners import artist
    from safe_denoiser_tpu_torch.runners.nudity import main as run_nudity

    tmp, ckpt = assets["tmp"], assets["ckpt"]
    bank = os.path.join(tmp, "artist_bank", "ann_graham_lotz")
    os.makedirs(bank)
    rs = np.random.RandomState(4)
    for i in range(ARTIST_BANK):
        write_png(rs.randint(0, 256, (512, 512, 3), dtype=np.uint8),
                  os.path.join(bank, f"{i:03d}.png"))
    out_counts = {}
    for task, samples, config in (("ann_graham", ARTIST_SAMPLES,
                                   "ann_graham/safe_denoiser.yaml"),
                                  ("munch", 1, "munch/safe_denoiser.yaml")):
        yaml_path = os.path.join(tmp, f"{task}.yaml")
        cfg = _task_yaml(
            yaml_path, config,
            {"proj_ref_path": os.path.join(tmp, f"{task}_proj.pt")},
            {"root": os.path.join(tmp, "artist_bank"),
             "class_info": "ann_graham_lotz"})
        out = os.path.join(tmp, f"out_{task}")
        wall, counts, log = _run_quiet(lambda argv: artist.main(task, argv), [
            "--save-dir", out, "--erase_id", "std_rep", "--model_dir", ckpt,
            "--task_config", yaml_path, "--num-samples", str(samples),
            "--num_inference_steps", "50", "--device", "cuda"])
        n_embed = cfg["repellency"]["n_embed"]
        want = runner_launches(pipe, samples, 10, ARTIST_BANK // n_embed,
                               n_embed)
        spec = artist.ARTIST_TASKS[task]
        names = sorted(os.listdir(os.path.join(out, "all")))
        logs = open(os.path.join(out, "logs.txt")).read()
        print(f"artist {task}: {samples} samples x 50 steps at 512^2, "
              f"guidance {spec['guidance']}, kernel_fast sigma "
              f"{cfg['repellency']['params']['sigma']} scale "
              f"{cfg['repellency']['params']['scale']}, bank {ARTIST_BANK} "
              f"PNGs: wall_s={wall:.3f} per_sample_s="
              f"{[round(v, 2) for v in _case_walls(out)]} outputs {names}")
        problems = []
        if names != [f"{i}.png" for i in range(samples)] or json.load(open(
                os.path.join(out, "detect_dict.json"))) != {}:
            problems.append("all/ or detect_dict.json")
        if f"Seed: 42, target prompt: {spec['prompt']}" not in logs or \
                read_png(os.path.join(out, "all", "0.png")).shape != \
                (512, 512, 3):
            problems.append("logs.txt or image")
        if problems:
            print(log[-4000:])
            fail(f"artist {task}: " + "; ".join(problems))
        check_launches(counts, want, f"artist {task}")
        out_counts[f"artist {task}"] = counts

    # SPELL: spell.yaml's parameters, a cached projected bank
    g = torch.Generator(device="cuda").manual_seed(5)
    refs = torch.randn(515, 4, 64, 64, device="cuda", generator=g)
    proj = os.path.join(tmp, "spell_proj.pt")
    torch.save((refs / refs.norm(dim=1, keepdim=True)).cpu(), proj)
    del refs
    yaml_path = os.path.join(tmp, "spell.yaml")
    cfg = _task_yaml(yaml_path, "sparse_repellency/spell.yaml",
                     {"proj_ref_path": proj,
                      "proj_noisy_ref_path_for_beta":
                          os.path.join(tmp, "spell_noisy.pt")},
                     {"root": os.path.join(tmp, "unused")})
    csv_path = os.path.join(tmp, "spell.csv")
    with open(csv_path, "w") as f:
        f.write("case_number,prompt,evaluation_seed,categories\n")
        for i, p in enumerate(PROMPTS[:SPELL_CASES]):
            f.write(f"{i},{p},{200 + i},sexual\n")
    out = os.path.join(tmp, "out_spell")
    wall, counts, log = _run_quiet(run_nudity, [
        "--data", csv_path, "--save-dir", out, "--erase_id", "std_rep",
        "--model_dir", ckpt, "--task_config", yaml_path, "--nudenet-path",
        assets["onnx"], "--num_inference_steps", "50", "--device", "cuda"])
    params = cfg["repellency"]["params"]
    names = {f"{i}_sexual.png" for i in range(SPELL_CASES)}
    listing = {d: set(os.listdir(os.path.join(out, d)))
               for d in ("all", "safe", "unsafe")}
    logs = open(os.path.join(out, "logs.txt")).read()
    print(f"spell runner: {SPELL_CASES} cases x 50 steps at 512^2, sparse "
          f"radius {params['radius']} scale {params['scale']}, cached bank "
          f"[515,4,64,64]: wall_s={wall:.3f} per_case_s="
          f"{[round(v, 2) for v in _case_walls(out)]} applied_lines="
          f"{logs.count('Repellency applied')}")
    if (listing["all"] != names or listing["safe"] | listing["unsafe"]
            != names or "Repellency method : sparse" not in logs):
        print(log[-4000:])
        fail(f"spell runner: output tree or logs ({listing})")
    check_launches(counts, runner_launches(pipe, SPELL_CASES, 0),
                   "spell runner")
    out_counts["spell runner"] = counts
    if profile:
        from safe_denoiser_tpu_torch.pipeline import ERASE_SPECS
        from safe_denoiser_tpu_torch.repellency import SparseRepellency
        proc = SparseRepellency(ref_data=None, embed_fn=None,
                                cache_proj_ref=True, proj_ref_path=proj,
                                radius=float(params["radius"]),
                                scale=float(params["scale"]))
        profile_call(lambda: pipe.generate_batch(
            [PROMPTS[0]], seeds=[200], guidance_scales=[7.5],
            num_inference_steps=10, repellency_processor=proc,
            erase_spec=ERASE_SPECS["std_rep"]),
            "spell case, 10 steps, batch 1, bank 515")
    phase_spell_force(pipe, float(params["scale"]), tmp)
    phase_conditioning()
    return out_counts


def phase_spell_force(pipe, scale: float, tmp: str) -> None:
    """The SPELL force reaching the latents at full width. A random
    channel-normalized bank lies ~90 apart row to row and at least ~64
    from any x0, outside spell.yaml's radius, so the sparse run above
    shows the path but not the force. Here the bank holds SPELL_COPIES
    perturbed copies (|noise| ~ 6.4) of each prompt's x0 at the first
    step (a .pt cache, not projected) and the radius is 12.8, so each x0
    has its copies in range. Two
    5-step batches (t = 801 ... 1: one step in [1000, 780]) at ``scale``
    and 0 must differ, on that step only, with no B2 launch."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.pipeline import EraseSpec, RepellencyWindow
    from safe_denoiser_tpu_torch.repellency import SparseRepellency

    dev = pipe.device
    steps, seeds, n = 5, [0, 1, 2, 3], len(PROMPTS)
    t, x0 = first_step_x0(pipe, steps, seeds)
    g = torch.Generator(device=dev).manual_seed(6)
    near = x0.repeat_interleave(SPELL_COPIES, 0) + 0.05 * torch.randn(
        n * SPELL_COPIES, 4, 64, 64, device=dev, generator=g)
    far = torch.randn(515 - n * SPELL_COPIES, 4, 64, 64, device=dev,
                      generator=g)
    bank = torch.cat([near, far / far.norm(dim=1, keepdim=True)])
    path = os.path.join(tmp, "spell_force_bank.pt")
    torch.save(bank.cpu(), path)          # a cache: taken as it is
    spec = EraseSpec(repellency=True, window=RepellencyWindow(1000.0, 780.0))
    out = {}
    for s in (scale, 0.0):
        proc = SparseRepellency(ref_data=None, embed_fn=None,
                                cache_proj_ref=True, proj_ref_path=path,
                                radius=12.8, scale=s, device=dev)
        ops.reset_launch_counts()
        pending = pipe.dispatch_batch(
            PROMPTS, seeds=seeds, guidance_scales=[7.5] * n,
            num_inference_steps=steps, height=512, width=512,
            repellency_processor=proc, erase_spec=spec)
        out[s] = (pending.fetch(return_latents=True).float(),
                  pending.applied.cpu(), ops.launch_counts()["rbf"])
    (lat_a, applied, rbf_n), (lat_b, _, _) = out[scale], out[0.0]
    gap = (lat_a - lat_b).abs().max().item()
    print(f"spell force: 4 x 512^2, {steps} steps, bank of own x0 (+noise) "
          f"at t={t}, radius 12.8, scale {scale}: applied per step "
          f"{applied.any(1).tolist()} rbf launches {rbf_n} "
          f"max|latents(scale {scale}) - latents(scale 0)|={gap:.4e}")
    if not (bool(applied[0].all()) and not bool(applied[1:].any())
            and rbf_n == 0 and gap > 0
            and bool(torch.isfinite(lat_a).all())):
        fail("at full width the SPELL force did not reach the latents")


def phase_conditioning() -> None:
    """The euclidean, kernel and lsh processors' ``conditioning`` at full
    width, x0 [4, 4, 64, 64] against a bank [515, 4, 64, 64] on cuda
    (euclidean through B2), against the same call with x0 on the CPU
    (the plain versions); bound 1e-4 (B2's, on a score of scale <= 1)."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.repellency import get_repellency_method

    g = torch.Generator(device="cuda").manual_seed(7)
    bank = torch.randn(515, 4, 64, 64, device="cuda", generator=g)
    x0 = bank[:4] + 0.05 * torch.randn(4, 4, 64, 64, device="cuda",
                                       generator=g)
    for name in ("euclidean", "kernel", "lsh"):
        t0 = time.perf_counter()
        proc = get_repellency_method(
            name, ref_data=bank, embed_fn=lambda x: x, n_embed=64,
            sigma=60.0, scale=0.5, n_components=32, hash_size=8,
            num_hashtables=4)
        built = time.perf_counter() - t0
        ops.reset_launch_counts()
        got = proc.conditioning(x0)
        torch.cuda.synchronize()
        rbf_n = ops.launch_counts()["rbf"]
        want = proc.conditioning(x0.cpu())
        err = (got["x_0_hat"].cpu() - want["x_0_hat"]).abs().max().item()
        moved = (want["x_0_hat"] - x0.cpu()).abs().max().item()
        print(f"conditioning {name}: x0 [4,4,64,64] bank [515,4,64,64] "
              f"cuda vs cpu max|d|={err:.3e} tol=1.0e-04 moved={moved:.3e} "
              f"rbf launches {rbf_n} built in {built:.2f} s")
        if not (err <= 1e-4 and moved > 0 and got["is_negation"]
                == want["is_negation"] is True
                and rbf_n == (name == "euclidean")):
            fail(f"conditioning {name}: the GPU disagrees with the CPU")


def phase_copro(pipe, assets: dict, profile: bool = False) -> dict:
    """6f: ``runners.copro`` at full SD-v1.4 width with the Q16 gate on a
    full ViT-L/14 tower (24 x 1024, 16 heads, MLP 4096, projection 768,
    224^2, patch 14; random weights from a seed written as an HF-named
    safetensors file) and a random [2, 768] prompt pickle: COPRO_CASES CSV
    prompts x 50 steps, kernel_fast without the beta gate (scale 0.03,
    sigma 3.55) against a cached random projected bank of COPRO_BANK rows.
    Checks the output tree, detect_dict.json and the launches; holds the
    tower's embedding of one output image on cuda against the CPU's (f32,
    TF32 off) and times the tower. With ``profile``, one CoPro case of 10
    steps on phase 4's modules, profiled. Returns the run's launch
    counts."""
    import pickle

    import numpy as np

    from safe_denoiser_tpu_torch.data.images import read_png
    from safe_denoiser_tpu_torch.evals.q16 import Q16Eval
    from safe_denoiser_tpu_torch.models import (CLIP_VISION_VIT_L_14,
                                                CLIPVisionModel)
    from safe_denoiser_tpu_torch.runners import copro

    tmp = assets["tmp"]
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(8)
    with torch.device("cuda"):
        tower = CLIPVisionModel(CLIP_VISION_VIT_L_14)
    init_small_(tower, gen)
    with torch.no_grad():
        tower.vision_model.embeddings.class_embedding.normal_(
            0.0, 0.02, generator=gen)
    n_params = sum(p.numel() for p in tower.parameters())
    weights = os.path.join(tmp, "clip_vit_l_14.safetensors")
    write_safetensors(weights, tower.state_dict())
    del tower
    prompts = os.path.join(tmp, "q16_prompts.p")
    with open(prompts, "wb") as f:
        pickle.dump(np.random.RandomState(9).randn(2, 768).astype(
            np.float32), f)
    refs = torch.randn(COPRO_BANK, 4, 64, 64, device="cuda", generator=gen)
    proj = os.path.join(tmp, "copro_proj.pt")
    torch.save((refs / refs.norm(dim=1, keepdim=True)).cpu(), proj)
    del refs
    yaml_path = os.path.join(tmp, "copro.yaml")
    cfg = _task_yaml(yaml_path, "copro/safe_denoiser.yaml",
                     {"proj_ref_path": proj, "cache_proj_ref": True,
                      "scale": 0.03, "sigma": 3.55},
                     {"root": os.path.join(tmp, "unused")})
    csv_path = os.path.join(tmp, "copro.csv")
    with open(csv_path, "w") as f:
        f.write("idx,unsafe_prompt,safe_prompt,concept,category\n")
        for i, p in enumerate(PROMPTS[:COPRO_CASES]):
            f.write(f"{10 + i},{p},{p},x,sexual\n")
    print(f"copro: ViT-L/14 tower of {n_params} parameters, prompts, "
          f"[{COPRO_BANK},4,64,64] bank and CSV written in "
          f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "out_copro")
    wall, counts, log = _run_quiet(copro.main, [
        "--data", csv_path, "--save-dir", out, "--erase_id", "std_rep",
        "--model_dir", assets["ckpt"], "--task_config", yaml_path,
        "--clip_vision_weights", weights, "--q16_path", prompts,
        "--num_inference_steps", "50", "--device", "cuda"])
    tags = {f"{10 + i}.png" for i in range(COPRO_CASES)}
    listing = {d: set(os.listdir(os.path.join(out, d)))
               for d in ("all", "safe", "unsafe")}
    detect = json.load(open(os.path.join(out, "detect_dict.json")))
    logs = open(os.path.join(out, "logs.txt")).read()
    print(f"copro: {COPRO_CASES} cases x 50 steps at 512^2, kernel_fast "
          f"without the beta gate (sigma {cfg['repellency']['params']['sigma']}"
          f", scale {cfg['repellency']['params']['scale']}), bank "
          f"{COPRO_BANK} rows, Q16 ViT-L/14: wall_s={wall:.3f} per_case_s="
          f"{[round(v, 2) for v in _case_walls(out)]} "
          f"unsafe={detect['unsafe']} applied_lines="
          f"{logs.count('Repellency applied')}")
    if (listing["all"] != tags or listing["safe"] | listing["unsafe"] != tags
            or listing["safe"] & listing["unsafe"]
            or len(detect["unsafe"]) != COPRO_CASES
            or logs.count("toxicity pred") != COPRO_CASES
            or [f"{10 + i}.png" in listing["unsafe"]
                for i in range(COPRO_CASES)] != detect["unsafe"]):
        print(log[-4000:])
        fail(f"copro: output tree, detect_dict.json or logs ({listing})")
    check_launches(counts, runner_launches(pipe, COPRO_CASES, 10),
                   "copro runner")
    if profile:
        from safe_denoiser_tpu_torch.pipeline import ERASE_SPECS
        from safe_denoiser_tpu_torch.repellency import KernelFastRepellency
        proc = KernelFastRepellency(
            ref_data=None, embed_fn=None, cache_proj_ref=True,
            proj_ref_path=proj, beta_threshold=1.0,
            **{k: cfg["repellency"]["params"][k] for k in ("sigma", "scale")})
        profile_call(lambda: pipe.generate_batch(
            [PROMPTS[0]], seeds=[10], guidance_scales=[7.5],
            num_inference_steps=10, repellency_processor=proc,
            erase_spec=ERASE_SPECS["std_rep"], use_beta_gate=False),
            f"copro case, 10 steps, batch 1, bank {COPRO_BANK}")

    # the tower on cuda against the CPU on one output image, f32
    img = read_png(os.path.join(out, "all", f"{10}.png"))
    gate = Q16Eval(prompts, clip_weights_path=weights)
    imgs = [img] * 4
    gate.compute_embeddings(imgs)                       # warm-up
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(5):
        gate.compute_embeddings(imgs)
    ev[1].record()
    torch.cuda.synchronize()
    per_image = ev[0].elapsed_time(ev[1]) / 20
    e_gpu = gate.compute_embeddings([img]).cpu()
    del gate
    e_cpu = Q16Eval(prompts, clip_weights_path=weights,
                    device="cpu").compute_embeddings([img])
    err = (e_gpu - e_cpu).abs().max().item()
    scale = e_cpu.abs().max().item()
    print(f"q16 tower: ViT-L/14 f32, {per_image:.3f} ms per image (groups "
          f"of 4, preprocessing 512->224 included); cuda vs cpu embedding "
          f"max|d|={err:.3e} max|e|={scale:.3e} tol={1e-4 * scale:.3e}")
    if not (err <= 1e-4 * scale and math.isfinite(scale) and scale > 0):
        fail("q16 tower: the GPU's embedding disagrees with the CPU's")
    return {"copro runner": counts}


def open_clip_state_dict(vision_sd: dict, text_sd: dict = None) -> dict:
    """The port's HF-named CLIP tower state dicts (tensors) in OpenCLIP's
    layout, as OpenCLIP checkpoints hold them: ``visual.*`` and the text
    keys, q/k/v packed into ``in_proj``, the projections right-multiplied
    ([width, out])."""
    def layers(sd, src, dst, out):
        i = 0
        while f"{src}.{i}.layer_norm1.weight" in sd:
            s, d = f"{src}.{i}", f"{dst}.{i}"
            for part in ("weight", "bias"):
                out[f"{d}.attn.in_proj_{part}"] = torch.cat(
                    [sd[f"{s}.self_attn.{n}_proj.{part}"] for n in "qkv"])
                for mine, theirs in (("layer_norm1", "ln_1"),
                                     ("layer_norm2", "ln_2"),
                                     ("self_attn.out_proj", "attn.out_proj"),
                                     ("mlp.fc1", "mlp.c_fc"),
                                     ("mlp.fc2", "mlp.c_proj")):
                    out[f"{d}.{theirs}.{part}"] = sd[f"{s}.{mine}.{part}"]
            i += 1

    v = "vision_model."
    out = {"visual.class_embedding": vision_sd[
               f"{v}embeddings.class_embedding"],
           "visual.positional_embedding": vision_sd[
               f"{v}embeddings.position_embedding.weight"],
           "visual.conv1.weight": vision_sd[
               f"{v}embeddings.patch_embedding.weight"],
           "visual.proj": vision_sd["visual_projection.weight"].T
           .contiguous()}
    for mine, theirs in (("pre_layrnorm", "ln_pre"),
                         ("post_layernorm", "ln_post")):
        for part in ("weight", "bias"):
            out[f"visual.{theirs}.{part}"] = vision_sd[f"{v}{mine}.{part}"]
    layers(vision_sd, f"{v}encoder.layers", "visual.transformer.resblocks",
           out)
    if text_sd is not None:
        t = "text_model."
        out.update({
            "token_embedding.weight":
                text_sd[f"{t}embeddings.token_embedding.weight"],
            "positional_embedding":
                text_sd[f"{t}embeddings.position_embedding.weight"],
            "ln_final.weight": text_sd[f"{t}final_layer_norm.weight"],
            "ln_final.bias": text_sd[f"{t}final_layer_norm.bias"],
            "text_projection": text_sd["text_projection.weight"].T
            .contiguous()})
        layers(text_sd, f"{t}encoder.layers", "transformer.resblocks", out)
    return out


def write_clip_b32(root: str, vocab_src: str, seed: int) -> int:
    """A random full CLIP ViT-B/32 (text 12 x 512, 8 heads; vision 12 x
    768; projections 512) as an HF-named sharded checkpoint directory (text
    and vision in two safetensors shards and their index) with the tiny
    vocab as tokenizer/. Both towers' final LayerNorms share one bias
    direction and the text projection is the vision one's first 512
    columns, so image-text cosines sit above CLIPScore's clamp at 0.
    Returns the parameter count."""
    from safe_denoiser_tpu_torch.models import (CLIP_VISION_VIT_B_32,
                                                CLIPTextModel,
                                                CLIPVisionModel)
    from safe_denoiser_tpu_torch.runners.coco30k import CLIP_TEXT_VIT_B_32

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        vision = init_small_(CLIPVisionModel(CLIP_VISION_VIT_B_32), gen)
        text = init_small_(CLIPTextModel(CLIP_TEXT_VIT_B_32,
                                         with_projection=True), gen)
    dt, dv = CLIP_TEXT_VIT_B_32.hidden_size, CLIP_VISION_VIT_B_32.hidden_size
    with torch.no_grad():
        vision.vision_model.embeddings.class_embedding.normal_(
            0.0, 0.02, generator=gen)
        shared = torch.randn(dt, device="cuda", generator=gen)
        post, final = (vision.vision_model.post_layernorm,
                       text.text_model.final_layer_norm)
        post.weight.fill_(0.5)
        final.weight.fill_(0.5)
        post.bias.copy_(torch.cat([shared,
                                   torch.zeros(dv - dt, device="cuda")]))
        final.bias.copy_(shared)
        text.text_projection.weight.copy_(
            vision.visual_projection.weight[:, :dt])
    os.makedirs(root)
    shards = {"model-00001-of-00002.safetensors": text.state_dict(),
              "model-00002-of-00002.safetensors": vision.state_dict()}
    for name, sd in shards.items():
        write_safetensors(os.path.join(root, name), sd)
    with open(os.path.join(root, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": {k: name for name, sd in shards.items()
                                  for k in sd}}, f)
    copy_vocab(vocab_src, os.path.join(root, "tokenizer"))
    return sum(p.numel() for m in (vision, text) for p in m.parameters())


def phase_coco(pipe, assets: dict) -> tuple:
    """6g: BASELINE #2, ``runners.coco30k`` at full SD-v1.4 width on the
    checkpoint of ``assets``, with the in-loop CLIPScore on a random full
    CLIP ViT-B/32 (``write_clip_b32``):

    - vanilla (no task config): the COCO_IDS cases x 50 DDPM steps at
      batch 1 with CFG 7.5, 512^2 (``pipe.dispatch``);
    - the same cases with ``--batch_size`` COCO_BATCH, one
      ``dispatch_batch`` with each row's seed;
    - configs/coco/safe_denoiser.yaml's kernel_fast (sigma 3.15, scale
      0.33, beta margin 1.6 calibrated on the GPU from a cached random
      [515,4,64,64] bank), ``--erase_id std_rep``, COCO_SAFE_CASES cases:
      B2 on the 10 in-window steps of each.

    Checks each output tree (all/<case>.png; logs.txt with one CLIP line
    a case, finite, and their mean; config.yaml in per-case mode only)
    and every kernel's launches. Returns (the runs' launch counts, what
    6h reads: the CLIP directory, the CSV, the vanilla run's all/)."""
    import re

    from safe_denoiser_tpu_torch.data.images import read_png
    from safe_denoiser_tpu_torch.runners import coco30k
    from safe_denoiser_tpu_torch.utils.config import load_yaml

    tmp, ckpt = assets["tmp"], assets["ckpt"]
    t0 = time.perf_counter()
    clip_dir = os.path.join(tmp, "clip_vit_b_32")
    n_params = write_clip_b32(clip_dir, os.path.join(tmp, "vocab"), seed=10)
    csv_path = os.path.join(tmp, "coco.csv")
    with open(csv_path, "w") as f:
        f.write("coco_id,prompt,evaluation_seed,case_number\n")
        for i, (cid, p) in enumerate(zip(COCO_IDS, PROMPTS)):
            f.write(f"{cid},{p},{300 + i},{cid}\n")
    g = torch.Generator(device="cuda").manual_seed(11)
    refs = torch.randn(515, 4, 64, 64, device="cuda", generator=g)
    proj = os.path.join(tmp, "coco_proj.pt")
    torch.save((refs / refs.norm(dim=1, keepdim=True)).cpu(), proj)
    del refs
    yaml_path = os.path.join(tmp, "coco.yaml")
    _task_yaml(yaml_path, "coco/safe_denoiser.yaml",
               {"proj_ref_path": proj, "proj_noisy_ref_path_for_beta":
                os.path.join(tmp, "coco_noisy.pt")},
               {"root": os.path.join(tmp, "unused")})
    print(f"coco: CLIP ViT-B/32 of {n_params} parameters (sharded, "
          f"HF names), CSV and [515,4,64,64] bank written in "
          f"{time.perf_counter() - t0:.1f} s")

    n, n_safe = len(COCO_IDS), COCO_SAFE_CASES
    runs = (("coco per case", [], n,
             runner_launches(pipe, n, 0)),
            ("coco batched", ["--batch_size", str(COCO_BATCH)], n,
             runner_launches(pipe, n // COCO_BATCH, 0, batch=COCO_BATCH)),
            ("coco safe", ["--task_config", yaml_path, "--erase_id",
                           "std_rep", "--valid_case_numbers", f"0,{n_safe}"],
             n_safe, runner_launches(pipe, n_safe, 10)))
    counts_out, outs = {}, {}
    for name, extra, cases, want in runs:
        out = os.path.join(tmp, "out_" + name.replace(" ", "_"))
        wall, counts, log = _run_quiet(coco30k.main, [
            "--data", csv_path, "--save-dir", out, "--model_dir", ckpt,
            "--clip_weights_dir", clip_dir, "--num_inference_steps", "50",
            "--device", "cuda", *extra])
        logs = open(os.path.join(out, "logs.txt")).read()
        scores = [float(v) for v in re.findall(
            r"CLIP score \(Case#: \d+\): (\S+)", logs)]
        mean = re.findall(r"mean CLIP score: (\S+) over (\d+) images", logs)
        walls = [float(v) for v in re.findall(
            r"Wall-Clock Time for (?:image generation \(Case#: \d+\)|batch "
            r"of \d+): ([0-9.]+) seconds", logs)]
        names = sorted(os.listdir(os.path.join(out, "all")))
        print(f"{name}: {cases} cases x 50 steps at 512^2: wall_s="
              f"{wall:.3f} walls_s={walls} clip_scores={scores} "
              f"mean={mean}")
        problems = []
        if names != sorted(f"{c}.png" for c in COCO_IDS[:cases]):
            problems.append(f"all/ holds {names}")
        if (len(scores) != cases or not all(map(math.isfinite, scores))
                or [n for _, n in mean] != [str(cases)]
                or not math.isfinite(float(mean[0][0]))):
            problems.append("CLIP score lines")
        per_case = name != "coco batched"
        if os.path.exists(os.path.join(out, "config.yaml")) != per_case:
            problems.append("config.yaml (per-case mode only)")
        if len(walls) != (cases if per_case else cases // COCO_BATCH):
            problems.append("wall-clock lines")
        if name == "coco safe" and (
                "Repellency method : kernel_fast" not in logs
                or load_yaml(os.path.join(out, "config.yaml"))[
                    "repellency"]["params"]["beta_threshold_margin"] != 1.6):
            problems.append("the safe run's repellency")
        img = read_png(os.path.join(out, "all", names[0])) if names else None
        if img is None or img.shape != (512, 512, 3):
            problems.append("image")
        if problems:
            print(log[-4000:])
            fail(f"{name}: " + "; ".join(problems))
        check_launches(counts, want, name)
        counts_out[name] = counts
        outs[name] = out
    info = {"clip_dir": clip_dir, "csv": csv_path,
            "samples": os.path.join(outs["coco per case"], "all")}
    return counts_out, info


def phase_offline_eval(assets: dict, coco: dict) -> None:
    """6h: the offline evaluators on the card over 6g's and 6f's outputs,
    f32 without TF32 (each tower's switch), with no port kernel launched:

    - ``runners.evaluate coco30k_fid_clip --allow_random_init`` on 6g's
      vanilla all/ against COCO_REFS random 512^2 reference PNGs: FID, KID
      and log-KID (the 2048^2 sqrtm on the host, timed), then CLIPScore
      with 6g's ViT-B/32 directory;
    - ``runners.evaluate copro_aes_clip`` on 6f's all/ with 6f's ViT-L/14
      file and a random AES MLP .pth, CLIPScore by CoPro's columns;
    - ``evaluate_image_similarity`` with a random full OpenCLIP ViT-H-14
      vision tower (32 x 1280, an OpenCLIP-named safetensors file, written
      and read once) between 6g's all/ and the references of their ids;
    - the Inception's (pool3, logits) on cuda against the CPU's within
      1e-4 of the largest magnitude.

    Prints each tower's time per image on the card."""
    import numpy as np

    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.data.images import write_png
    from safe_denoiser_tpu_torch.device import ieee_f32
    from safe_denoiser_tpu_torch.evals import offline
    from safe_denoiser_tpu_torch.models import (CLIP_VISION_VIT_H_14,
                                                CLIP_VISION_VIT_L_14,
                                                CLIPVisionModel,
                                                preprocess_clip)
    from safe_denoiser_tpu_torch.runners import evaluate
    from safe_denoiser_tpu_torch.runners.coco30k import InLoopClipScore
    from safe_denoiser_tpu_torch.utils.config import load_yaml

    tmp = assets["tmp"]
    t0 = time.perf_counter()
    refs = os.path.join(tmp, "coco_refs")
    os.makedirs(refs)
    rs = np.random.RandomState(12)
    ref_ids = list(COCO_IDS) + [100 + i for i in range(COCO_REFS
                                                        - len(COCO_IDS))]
    for cid in ref_ids:
        write_png(rs.randint(0, 256, (512, 512, 3), dtype=np.uint8),
                  os.path.join(refs, f"{cid}.png"))
    gen = torch.Generator(device="cuda").manual_seed(13)
    aes = torch.nn.Sequential(
        torch.nn.Linear(768, 1024), torch.nn.Dropout(0.2),
        torch.nn.Linear(1024, 128), torch.nn.Dropout(0.2),
        torch.nn.Linear(128, 64), torch.nn.Dropout(0.1),
        torch.nn.Linear(64, 16), torch.nn.Linear(16, 1)).cuda()
    init_small_(aes, gen, std=0.05)
    aes_path = os.path.join(tmp, "aes.pth")
    torch.save({f"layers.{k}": v.cpu() for k, v in aes.state_dict().items()},
               aes_path)
    with torch.device("cuda"):
        h14 = CLIPVisionModel(CLIP_VISION_VIT_H_14).eval()
    init_small_(h14, gen)
    px = torch.rand(1, 3, 224, 224, device="cuda", generator=gen)
    with torch.no_grad():
        h14.vision_model.embeddings.class_embedding.normal_(0.0, 0.02,
                                                            generator=gen)
        with ieee_f32():    # timed here: the file is written and read once
            tower_ms = {"H/14": device_ms(lambda: h14(px))}
    n_h14 = sum(p.numel() for p in h14.parameters())
    h14_path = os.path.join(tmp, "open_clip_vit_h_14.safetensors")
    write_safetensors(h14_path, open_clip_state_dict(h14.state_dict()))
    del h14
    torch.cuda.empty_cache()
    print(f"offline eval: {COCO_REFS} reference PNGs, AES MLP and OpenCLIP "
          f"ViT-H-14 vision tower ({n_h14} parameters) written in "
          f"{time.perf_counter() - t0:.1f} s")

    sqrtm_s = []
    frechet = offline.frechet_distance

    def timed_frechet(*a, **k):
        t = time.perf_counter()
        try:
            return frechet(*a, **k)
        finally:
            sqrtm_s.append(time.perf_counter() - t)

    samples = coco["samples"]
    ops.reset_launch_counts()
    offline.frechet_distance = timed_frechet
    t0 = time.perf_counter()
    try:
        evaluate.main(["coco30k_fid_clip", "--sample_dir", samples,
                       "--dataset_root", refs, "--allow_random_init",
                       "--prompts_csv", coco["csv"], "--clip_weights_dir",
                       coco["clip_dir"], "--device", "cuda"])
    finally:
        offline.frechet_distance = frechet
    wall_fid = time.perf_counter() - t0
    parent = os.path.dirname(samples)
    fid = load_yaml(os.path.join(parent, "metrics_org_coco30k_10k.yaml"))
    clip = load_yaml(os.path.join(parent, "metrics_clip_score.yaml"))
    print(f"offline coco30k_fid_clip: {fid} {clip} wall_s={wall_fid:.3f} "
          f"frechet_distance host_s={[round(v, 3) for v in sqrtm_s]} "
          "(sqrtm of a 2048^2 product)")
    if not (set(fid) == {"fid", "kid", "log_kid"}
            and all(math.isfinite(v) for v in fid.values())
            and clip["n"] == len(COCO_IDS) and math.isfinite(
                clip["clip_score"])):
        fail("offline coco30k_fid_clip: metrics files")

    copro_all = os.path.join(tmp, "out_copro", "all")
    t0 = time.perf_counter()
    evaluate.main(["copro_aes_clip", "--sample_dir", copro_all,
                   "--prompts_csv", os.path.join(tmp, "copro.csv"),
                   "--aes_weights", aes_path, "--clip_vision_weights",
                   os.path.join(tmp, "clip_vit_l_14.safetensors"),
                   "--clip_weights_dir", coco["clip_dir"],
                   "--device", "cuda"])
    wall_aes = time.perf_counter() - t0
    parent = os.path.dirname(copro_all)
    aes_res = load_yaml(os.path.join(parent, "metrics_aes.yaml"))
    clip = load_yaml(os.path.join(parent, "metrics_clip_score.yaml"))
    print(f"offline copro_aes_clip: {aes_res} {clip} wall_s={wall_aes:.3f}")
    if not (aes_res["n"] == COPRO_CASES and math.isfinite(aes_res["aes_score"])
            and clip["n"] == COPRO_CASES
            and math.isfinite(clip["clip_score"])):
        fail("offline copro_aes_clip: metrics files")

    t0 = time.perf_counter()
    sim = offline.evaluate_image_similarity(samples, refs, h14_path,
                                            device="cuda")
    wall_sim = time.perf_counter() - t0
    print(f"offline image similarity, OpenCLIP ViT-H-14: {sim} "
          f"wall_s={wall_sim:.3f} (file read included)")
    if sim["n"] != len(COCO_IDS) or not math.isfinite(
            sim["image_clip_similarity"]):
        fail("offline image similarity: metrics")
    check_launches(ops.launch_counts(),
                   dict.fromkeys(EXPECTED_LAUNCHES, 0), "offline evaluators")

    # the towers' time per image on the card: Inception at batch 32 (device
    # time of the forward), the ViTs at batch 1 as the evaluators run them
    # (device time of the forward; the in-loop score also paced, with its
    # preprocessing and tokenization)
    x = torch.rand(32, 299, 299, 3, device="cuda", generator=gen)
    feats = offline.InceptionFeatures(allow_random_init=True, device="cuda")
    with torch.no_grad(), ieee_f32():
        inc_ms = device_ms(lambda: feats.model(x), reps=5) / 32
    got = feats.features(x[:2].cpu().numpy())
    del feats
    want = offline.InceptionFeatures(allow_random_init=True,
                                     device="cpu").features(
        x[:2].cpu().numpy())
    errs = [((a.cpu() - b).abs().max().item(), b.abs().max().item())
            for a, b in zip(got, want)]
    print(f"inception: {inc_ms:.4f} ms an image (device, batch 32, f32); "
          f"cuda vs cpu pool3 max|d|={errs[0][0]:.3e} (max {errs[0][1]:.3e})"
          f", logits max|d|={errs[1][0]:.3e} (max {errs[1][1]:.3e}), "
          f"tol 1e-4 x max")
    if not all(e <= 1e-4 * m and math.isfinite(m) and m > 0
               for e, m in errs):
        fail("inception: the GPU's features disagree with the CPU's")

    scorer = InLoopClipScore(coco["clip_dir"], device="cuda")
    img = rs.randint(0, 256, (512, 512, 3), dtype=np.uint8)
    b32_paced = cuda_ms(lambda: scorer(img, PROMPTS[0]), reps=20)
    t0 = time.perf_counter()
    for _ in range(20):
        scorer.tokenizer([PROMPTS[0]])
    tok_ms = (time.perf_counter() - t0) * 50
    ids = torch.as_tensor(scorer.tokenizer([PROMPTS[0]])["input_ids"],
                          device="cuda")
    pre_ms = cuda_ms(lambda: preprocess_clip(torch.as_tensor(
        img[None], device="cuda")), reps=20)
    with torch.no_grad(), ieee_f32():
        towers_paced = cuda_ms(lambda: (scorer.vision_model(px),
                                        scorer.text_model(ids)), reps=20)
        tower_ms["B/32 vision + text"] = device_ms(
            lambda: (scorer.vision_model(px), scorer.text_model(ids)))
        del scorer
        with torch.device("cuda"):
            l14 = CLIPVisionModel(CLIP_VISION_VIT_L_14).eval()
        tower_ms["L/14"] = device_ms(lambda: l14(px))
        del l14
        torch.cuda.empty_cache()
    print(f"clip towers, ms an image on the card (device, batch 1, f32): "
          f"{json.dumps({k: round(v, 4) for k, v in tower_ms.items()})}; "
          f"in-loop B/32 score paced {b32_paced:.4f} ms (512^2 image, "
          f"preprocessing and tokenization included): tokenizer "
          f"{tok_ms:.4f} ms host, preprocessing {pre_ms:.4f} ms paced, "
          f"both towers {towers_paced:.4f} ms paced")


def init_small_(module, gen: torch.Generator, std: float = 0.02):
    """Every parameter of two or more dims ~ N(0, std^2), drawn from
    ``gen``: random towers kept as small as bench.py's SD3 set-up keeps its
    fabricated ones, so 24 bf16 T5 blocks stay finite."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, std, generator=gen)
    return module


def build_random_sd3_pipeline(device, vocab_dir: str, mmdit_cfg=None,
                              t5_cfg=None, clip_l_cfg=None, clip_g_cfg=None,
                              vae_cfg=None, seed: int = 0,
                              dtype=torch.bfloat16, std: float = 0.02):
    """SafeDiffusion3Pipeline with weights drawn from ``seed``, built on
    ``device`` directly (the CLIP towers in f32, T5, the MMDiT and the VAE
    in ``dtype``), SD3-medium widths and depth unless configs are given;
    the towers' matrices ~ N(0, std^2), the VAE's PyTorch's defaults. All
    three tokenizers are the BPE of ``vocab_dir``."""
    import dataclasses

    from safe_denoiser_tpu_torch.models import (
        CLIP_BIG_G, CLIP_VIT_L_14, SD3_MEDIUM, SD3_VAE, T5_XXL,
        AutoencoderKL, CLIPTextModel, MMDiT, T5Encoder)
    from safe_denoiser_tpu_torch.pipeline.diffusion_sd3 import \
        SafeDiffusion3Pipeline
    from safe_denoiser_tpu_torch.schedulers import FlowMatchEulerScheduler
    from safe_denoiser_tpu_torch.text import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(vocab_dir)
    eos = dict(eos_token_id=tok.eos_token_id)
    torch.manual_seed(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    prev = torch.get_default_dtype()
    with torch.device(device):
        clip_l, clip_g = (
            init_small_(CLIPTextModel(dataclasses.replace(cfg, **eos),
                                      with_projection=True), gen, std)
            for cfg in (clip_l_cfg or CLIP_VIT_L_14, clip_g_cfg or CLIP_BIG_G))
        torch.set_default_dtype(dtype)     # build the big towers in dtype
        try:
            t5 = init_small_(T5Encoder(t5_cfg or T5_XXL), gen, std)
            mmdit = init_small_(MMDiT(mmdit_cfg or SD3_MEDIUM), gen, std)
            vae = AutoencoderKL(vae_cfg or SD3_VAE)
        finally:
            torch.set_default_dtype(prev)
    return SafeDiffusion3Pipeline(mmdit, vae, clip_l, clip_g, t5, tok, tok,
                                  tok, FlowMatchEulerScheduler(),
                                  device=device)


def write_sd3_checkpoint(pipe, root: str, vocab_src: str) -> None:
    """``pipe``'s modules as an HF-layout SD3 checkpoint: transformer/ (two
    safetensors shards and their index), vae/, text_encoder/,
    text_encoder_2/, text_encoder_3/ (safetensors in the modules' dtypes,
    diffusers/HF config.json), tokenizer/, tokenizer_2/, tokenizer_3/ from
    ``vocab_src``, and the scheduler's config."""
    import dataclasses

    m, t = pipe.transformer.config, pipe.t5.config

    def clip_cfg(c):
        return dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                    num_hidden_layers=c.num_layers,
                    num_attention_heads=c.num_heads,
                    max_position_embeddings=c.max_position_embeddings,
                    intermediate_size=c.intermediate_size,
                    hidden_act=c.hidden_act, projection_dim=c.projection_dim,
                    eos_token_id=c.eos_token_id)

    parts = {
        "transformer": (pipe.transformer, dict(
            sample_size=m.sample_size, patch_size=m.patch_size,
            in_channels=m.in_channels, out_channels=m.out_channels,
            num_layers=m.num_layers, num_attention_heads=m.num_heads,
            attention_head_dim=m.head_dim,
            joint_attention_dim=m.joint_attention_dim,
            caption_projection_dim=m.caption_projection_dim,
            pooled_projection_dim=m.pooled_projection_dim,
            pos_embed_max_size=m.pos_embed_max_size, qk_norm=m.qk_norm)),
        "vae": (pipe.vae, dataclasses.asdict(pipe.vae.config)),
        "text_encoder": (pipe.clip_l, clip_cfg(pipe.clip_l.config)),
        "text_encoder_2": (pipe.clip_g, clip_cfg(pipe.clip_g.config)),
        "text_encoder_3": (pipe.t5, dataclasses.asdict(t)),
    }
    for sub, (module, cfg) in parts.items():
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg, f)
        sd = module.state_dict()
        if sub != "transformer":
            write_safetensors(os.path.join(root, sub, "model.safetensors"),
                              sd)
            continue
        keys = sorted(sd)
        shards = {"diffusion_pytorch_model-00001-of-00002.safetensors":
                  keys[:len(keys) // 2],
                  "diffusion_pytorch_model-00002-of-00002.safetensors":
                  keys[len(keys) // 2:]}
        for fname, ks in shards.items():
            write_safetensors(os.path.join(root, sub, fname),
                              {k: sd[k] for k in ks})
        with open(os.path.join(root, sub, "diffusion_pytorch_model."
                               "safetensors.index.json"), "w") as f:
            json.dump({"weight_map": {k: fn for fn, ks in shards.items()
                                      for k in ks}}, f)
    for tok in ("tokenizer", "tokenizer_2", "tokenizer_3"):
        copy_vocab(vocab_src, os.path.join(root, tok))
    os.makedirs(os.path.join(root, "scheduler"))
    with open(os.path.join(root, "scheduler", "scheduler_config.json"),
              "w") as f:
        json.dump(dict(dataclasses.asdict(pipe.scheduler.config),
                       _class_name="FlowMatchEulerDiscreteScheduler"), f)


def sd3_expected_launches(pipe, steps: int, window, layers: int,
                          int8_attention: bool, layout: str = "bhsd"
                          ) -> dict:
    """One SD3 image's launches, from the JAX package's gates: the joint
    attention once per block and step through the layout's kernels (bhsd:
    B8 under SDT_INT8_ATTN=1, else B1; nt never int8); B2 once per step
    whose timestep lies in the window (the flow-match table); adaln 6L - 1
    times a step; B3/B4/B5 as the VAE decode's routing gives them."""
    ts, _ = pipe.scheduler.timesteps_and_sigmas(steps)
    side = SD3_SIDE // pipe.vae_scale_factor
    dec = vae_kernel_plan(pipe.vae.config, 1, side, side)[0]
    return {**attention_launches(layout, layers * steps, int8_attention),
            "rbf": sum(bool(window.mask(i, float(t)))
                       for i, t in enumerate(ts)),
            **adaln_launches(layers, steps), **dec}


def adaln_launches(layers: int, calls: int) -> dict:
    """adaln's launches in ``calls`` MMDiT forwards of ``layers`` blocks: 6
    a block (norm1, norm1_context, the two residual + norms and the two
    trailing residuals), 4 in the last (context_pre_only), 1 for
    norm_out."""
    return {"adaln": (6 * layers - 1) * calls}


def _check_images(images, side: int, what: str) -> None:
    if not images or any(im.dtype.name != "uint8"
                         or im.shape != (side, side, 3) for im in images):
        fail(f"{what}: images {[(im.dtype, im.shape) for im in images]}")


def phase_sd3(profile: bool = False) -> dict:
    """SD3-medium at full width and depth: bf16, bf16 under nt + repack,
    then int8 (with ``profile``, a profiled 5-step image after each);
    returns the launch counts of each run."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.pipeline import RepellencyWindow
    from safe_denoiser_tpu_torch.repellency import KernelFastRepellency

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as vocab_dir:
        write_tiny_vocab(vocab_dir)
        pipe = build_random_sd3_pipeline(dev, vocab_dir)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("transformer", "t5", "clip_l", "clip_g", "vae")}
    print(f"sd3: SD3-medium widths and depth, random weights (seed 0), built "
          f"on the GPU in {time.perf_counter() - t0:.1f} s; parameters "
          f"{json.dumps(n_params)}; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    g = torch.Generator(device=dev).manual_seed(1)
    bank = torch.randn(SD3_BANK, 16, SD3_SIDE // 8, SD3_SIDE // 8,
                       generator=g, device=dev)
    proc = KernelFastRepellency(ref_data=bank, embed_fn=lambda x: x,
                                sigma=2.75, scale=0.03, normalize_x=True)
    window = RepellencyWindow(1000.0, 780.0)
    kw = dict(seed=0, guidance_scale=2.5, height=SD3_SIDE, width=SD3_SIDE,
              repellency_processor=proc, window=window)
    layers = pipe.transformer.config.num_layers
    out = {}
    try:
        for mode in ("bf16", "nt+repack", "int8"):
            layout = mode if mode in LAYOUTS else "bhsd"
            if mode == "int8":
                n_q = pipe.enable_int8()
                want_q = 12 * (layers - 1) + 9    # the JAX selection's count
                print(f"sd3 int8: {n_q} MMDiT linears quantized (W8A8), "
                      f"expected {want_q}")
                if n_q != want_q:
                    fail(f"enable_int8 quantized {n_q} linears, the JAX "
                         f"package's selection {want_q}")
                os.environ["SDT_INT8_ATTN"] = "1"
            with layout_env(layout):
                pipe.dispatch(SD3_PROMPT, num_inference_steps=2,
                              **kw).fetch()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                pending = pipe.dispatch(SD3_PROMPT,
                                        num_inference_steps=SD3_STEPS, **kw)
                images = pending.fetch()
                wall = time.perf_counter() - t0
                counts = ops.launch_counts()
            if not bool(torch.isfinite(pending.latents).all()
                        and torch.isfinite(pending.image).all()):
                fail(f"sd3 {mode}: non-finite latents or image")
            _check_images(images, SD3_SIDE, f"sd3 {mode}")
            st = pending.stage_ms
            want = sd3_expected_launches(pipe, SD3_STEPS, window, layers,
                                         mode == "int8", layout)
            print(f"sd3 {mode}: 1 x {SD3_SIDE}^2, {SD3_STEPS} flow-match "
                  f"steps, CFG 2.5, kernel_fast [1000,780]: "
                  f"encode_ms={st['encode']:.2f} loop_ms={st['loop']:.2f} "
                  f"decode_ms={st['decode']:.2f} wall_s={wall:.3f} "
                  f"rep_applied_steps={int(pending.applied.any(1).sum())} "
                  f"image_mean={images[0].mean():.3f}")
            check_launches(counts, want, f"sd3 {mode}")
            out[mode] = (counts, images[0], pending.latents.float())
            if mode == "bf16":
                graph_check(pipe, "sd3 bf16", [SD3_PROMPT], [0],
                            guidance_scales=[2.5],
                            num_inference_steps=SD3_STEPS,
                            height=SD3_SIDE, width=SD3_SIDE,
                            repellency_processor=proc, window=window)
            if profile:
                with layout_env(layout):
                    profile_call(lambda: pipe.dispatch(
                        SD3_PROMPT, num_inference_steps=5, **kw).fetch(),
                        f"sd3 {mode}, 5 steps")
    finally:
        os.environ.pop("SDT_INT8_ATTN", None)
    for mode in ("nt+repack", "int8"):
        d_lat = (out["bf16"][2] - out[mode][2]).abs().max().item()
        d_img = abs(out["bf16"][1].astype(float) - out[mode][1]).mean()
        print(f"sd3 {mode} vs bf16: max|d| latents={d_lat:.4e} mean|d| "
              f"image (0..255)={d_img:.3f}")
    # the bf16 latents decoded again under SDT_UP_FORM=interleave: the
    # decoder's three upsamples on B7, none on B3
    counts = {mode: v[0] for mode, v in out.items()}
    vc = pipe.vae.config
    z = out["bf16"][2] / vc.scaling_factor + vc.shift_factor
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad():
        ev[0].record()
        planar = pipe.vae.decode(z).float()
        ev[1].record()
        with switches({"SDT_UP_FORM": "interleave"}):
            want = vae_kernel_plan(vc, 1, z.shape[2], z.shape[3])[0]
            ops.reset_launch_counts()
            ev[2].record()
            inter = pipe.vae.decode(z).float()
            ev[3].record()
            torch.cuda.synchronize()
            counts["decode interleave"] = ops.launch_counts()
    if not bool(torch.isfinite(inter).all()):
        fail("sd3 decode under SDT_UP_FORM=interleave: non-finite image")
    print(f"sd3 decode under SDT_UP_FORM=interleave vs the default decode of "
          f"the bf16 latents: max|d| image (-1..1)="
          f"{(inter - planar).abs().max().item():.4e}; decode_ms default="
          f"{ev[0].elapsed_time(ev[1]):.2f} interleave="
          f"{ev[2].elapsed_time(ev[3]):.2f}")
    check_launches(counts["decode interleave"], want,
                   "sd3 decode under SDT_UP_FORM=interleave")
    del pipe
    torch.cuda.empty_cache()
    return counts


def phase_sd3_runner() -> dict:
    """The SD3 runner on cuda with --int8 and SDT_INT8_ATTN=1 on an
    HF-layout checkpoint at the published widths with the depth cut of
    SD3_RUNNER_LAYERS: 16 bank PNGs VAE-encoded in chunks, SAFREE on, 2
    cases of 50 steps, the NudeNet-shaped gate. Checks the output tree and
    every kernel's launch count; then 8b (``phase_sd3_coco``) on the same
    checkpoint, whose launch counts it returns."""
    import contextlib
    import dataclasses
    import io
    import re

    import numpy as np

    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.data.images import write_png
    from safe_denoiser_tpu_torch.models import (CLIP_BIG_G, SD3_MEDIUM,
                                                T5_XXL)
    from safe_denoiser_tpu_torch.pipeline import RepellencyWindow
    from safe_denoiser_tpu_torch.runners.sdv3 import main_nudity

    cut = SD3_RUNNER_LAYERS
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        voc = os.path.join(tmp, "vocab")
        os.makedirs(voc)
        write_tiny_vocab(voc)
        pipe = build_random_sd3_pipeline(
            torch.device("cuda"), voc,
            mmdit_cfg=dataclasses.replace(SD3_MEDIUM,
                                          num_layers=cut["mmdit"]),
            t5_cfg=dataclasses.replace(T5_XXL, num_layers=cut["t5"]),
            clip_g_cfg=dataclasses.replace(CLIP_BIG_G,
                                           num_layers=cut["clip_g"]),
            seed=4)
        ckpt = os.path.join(tmp, "ckpt")
        write_sd3_checkpoint(pipe, ckpt, voc)
        want = sd3_expected_launches(pipe, SD3_STEPS,
                                     RepellencyWindow(1000.0, 780.0),
                                     cut["mmdit"], True)
        want = {k: v * SD3_RUNNER_CASES for k, v in want.items()}
        want_coco = sd3_expected_launches(pipe, SD3_STEPS,
                                          RepellencyWindow(1000.0, 780.0),
                                          cut["mmdit"], False)
        want_coco = {k: v * SD3_COCO_CASES for k, v in want_coco.items()}
        coco_bank = (SD3_BANK, pipe.transformer.config.in_channels,
                     SD3_SIDE // pipe.vae_scale_factor,
                     SD3_SIDE // pipe.vae_scale_factor)
        enc = vae_kernel_plan(pipe.vae.config, SD3_RUNNER_N_EMBED, SD3_SIDE,
                              SD3_SIDE, "encoder")[0]
        for k, v in enc.items():
            want[k] += v * (SD3_BANK // SD3_RUNNER_N_EMBED)
        del pipe
        torch.cuda.empty_cache()
        bank = os.path.join(tmp, "bank", "i2p_sexual")
        os.makedirs(bank)
        rs = np.random.RandomState(5)
        for i in range(SD3_BANK):
            write_png(rs.randint(0, 256, (SD3_SIDE, SD3_SIDE, 3),
                                 dtype=np.uint8),
                      os.path.join(bank, f"{i:03d}.png"))
        task = os.path.join(tmp, "task.yaml")
        with open(task, "w") as f:
            f.write(f"""# the SD3 nudity task's kernel_fast settings
repellency:
  method: kernel_fast
  n_embed: {SD3_RUNNER_N_EMBED}
  params:
    sigma: 2.75
    scale: 0.03
data:
  name: nudity
  root: {os.path.join(tmp, "bank")}
  class_info: i2p_sexual
  size: {SD3_SIDE}
""")
        csv_path = os.path.join(tmp, "prompts.csv")
        with open(csv_path, "w") as f:
            f.write("case_number,prompt,evaluation_seed,categories\n")
            for i, p in enumerate(PROMPTS[:SD3_RUNNER_CASES]):
                f.write(f"{i},{p},{200 + i},sexual\n")
        onnx = os.path.join(tmp, "nudenet.onnx")
        with open(onnx, "wb") as f:
            f.write(nudenet_like_onnx())
        print(f"sd3 runner: assets written in {time.perf_counter() - t0:.1f}"
              f" s (checkpoint with depth cut {json.dumps(cut)}, "
              f"{SD3_BANK} bank PNGs, task YAML, CSV, ONNX)")

        out = os.path.join(tmp, "out")
        log = io.StringIO()
        os.environ["SDT_INT8_ATTN"] = "1"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                main_nudity(["--data", csv_path, "--save-dir", out,
                             "--model_dir", ckpt, "--task_config", task,
                             "--nudenet-path", onnx, "--int8",
                             "--num_inference_steps", str(SD3_STEPS),
                             "--image_length", str(SD3_SIDE),
                             "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            os.environ.pop("SDT_INT8_ATTN", None)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        logs = open(os.path.join(out, "logs.txt")).read()
        per_case = [float(v) for v in re.findall(
            r"Wall-Clock Time for image generation \(Case#: \d+\): "
            r"([0-9.]+) seconds", logs)]
        names = {f"{i}_sexual.png" for i in range(SD3_RUNNER_CASES)}
        listing = {d: set(os.listdir(os.path.join(out, d)))
                   for d in ("all", "safe", "unsafe")}
        detect = json.load(open(os.path.join(out, "detect_dict.json")))
        print(f"sd3 runner: {SD3_RUNNER_CASES} cases x {SD3_STEPS} steps at "
              f"{SD3_SIDE}^2, --int8, SDT_INT8_ATTN=1, SAFREE: "
              f"wall_s={wall:.3f} per_case_s={per_case} "
              f"unsafe={detect['unsafe']}")
        print(f"sd3 runner launches: {json.dumps(counts)} expected "
              f"{json.dumps(want)}")
        problems = []
        if listing["all"] != names:
            problems.append(f"all/ holds {sorted(listing['all'])}")
        if (listing["safe"] | listing["unsafe"] != names
                or listing["safe"] & listing["unsafe"]):
            problems.append("safe/ and unsafe/ do not split the cases")
        if (len(detect["unsafe"]) != SD3_RUNNER_CASES
                or len(per_case) != SD3_RUNNER_CASES):
            problems.append("detect_dict.json or logs.txt miss cases")
        for line in ("int8: MMDiT block matmuls quantized (W8A8)",
                     "Repellency method : kernel_fast", "we remove",
                     "Repellency applied at timestep"):
            if line not in logs:
                problems.append(f"logs.txt lacks {line!r}")
        if not os.path.exists(os.path.join(out, "config.yaml")):
            problems.append("no config.yaml")
        for name, n in want.items():
            if counts[name] != n:
                problems.append(f"kernel {name} launched {counts[name]} "
                                f"times, expected {n}")
        if problems:
            print(log.getvalue()[-4000:])
            fail("sd3 runner phase: " + "; ".join(problems))
        counts = phase_sd3_coco(tmp, ckpt, want_coco, coco_bank)
        counts.update(phase_serve_sd3(tmp, ckpt, task))
        counts["sd3-flow-lora"] = phase_sd3_flow_lora(ckpt)
        return counts


def phase_sd3_coco(tmp: str, ckpt: str, want: dict, bank: tuple) -> dict:
    """8b: ``runners.sdv3 coco30k`` in bf16 (B1 at SD3's joint-attention
    shape, not B8) on phase 8's checkpoint under
    configs/coco/safe_denoiser_sdv3.yaml (kernel_fast renoising, no beta
    gate) against a cached random bank of shape ``bank`` ([16,16,128,128]):
    SD3_COCO_CASES CSV cases x 50 steps at 1024^2, SAFREE on. Checks the
    output tree (all/<case>.png, logs.txt, config.yaml without the task
    config, no gate files) and the launches ``want``; returns them."""
    import re

    from safe_denoiser_tpu_torch.data.images import read_png
    from safe_denoiser_tpu_torch.runners.sdv3 import main_coco30k
    from safe_denoiser_tpu_torch.utils.config import load_yaml

    g = torch.Generator(device="cuda").manual_seed(14)
    refs = torch.randn(*bank, device="cuda", generator=g)
    proj = os.path.join(tmp, "coco_sd3_proj.pt")
    torch.save((refs / refs.norm(dim=1, keepdim=True)).cpu(), proj)
    del refs
    yaml_path = os.path.join(tmp, "coco_sd3.yaml")
    _task_yaml(yaml_path, "coco/safe_denoiser_sdv3.yaml",
               {"proj_ref_path": proj}, {"root": os.path.join(tmp, "unused")})
    csv_path = os.path.join(tmp, "coco_sd3.csv")
    ids = COCO_IDS[:SD3_COCO_CASES]
    with open(csv_path, "w") as f:
        f.write("coco_id,prompt,evaluation_seed,case_number\n")
        for i, (cid, p) in enumerate(zip(ids, PROMPTS)):
            f.write(f"{cid},{p},{400 + i},{cid}\n")
    out = os.path.join(tmp, "out_coco")
    wall, counts, log = _run_quiet(main_coco30k, [
        "--data", csv_path, "--save-dir", out, "--model_dir", ckpt,
        "--task_config", yaml_path, "--num_inference_steps", str(SD3_STEPS),
        "--image_length", str(SD3_SIDE), "--device", "cuda"])
    logs = open(os.path.join(out, "logs.txt")).read()
    per_case = [float(v) for v in re.findall(
        r"Wall-Clock Time for image generation \(Case#: \d+\): "
        r"([0-9.]+) seconds", logs)]
    names = sorted(os.listdir(os.path.join(out, "all")))
    print(f"sd3 coco: {SD3_COCO_CASES} cases x {SD3_STEPS} steps at "
          f"{SD3_SIDE}^2, bf16, SAFREE, kernel_fast against a cached "
          f"{list(bank)} bank: wall_s={wall:.3f} "
          f"per_case_s={per_case} applied_lines="
          f"{logs.count('Repellency applied')}")
    problems = []
    if names != sorted(f"{c}.png" for c in ids):
        problems.append(f"all/ holds {names}")
    if len(per_case) != SD3_COCO_CASES:
        problems.append("wall-clock lines")
    for line in ("Repellency method : kernel_fast", "we remove",
                 "Repellency applied at timestep"):
        if line not in logs:
            problems.append(f"logs.txt lacks {line!r}")
    cfg_path = os.path.join(out, "config.yaml")
    if not os.path.exists(cfg_path) or "repellency" in load_yaml(cfg_path):
        problems.append("config.yaml (the flags alone)")
    if (os.path.exists(os.path.join(out, "detect_dict.json"))
            or os.listdir(os.path.join(out, "safe"))
            or os.listdir(os.path.join(out, "unsafe"))):
        problems.append("gate outputs in a COCO run")
    if read_png(os.path.join(out, "all", names[0])).shape != \
            (SD3_SIDE, SD3_SIDE, 3):
        problems.append("image")
    if problems:
        print(log[-4000:])
        fail("sd3 coco: " + "; ".join(problems))
    check_launches(counts, want, "sd3 coco")
    return {"sd3 coco": counts}


def _post_generate(port: int, body: dict, out: dict) -> None:
    """POST ``body`` to /generate; out[seed] = (status, JSON, seconds)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("POST", "/generate", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    data = json.loads(r.read())
    conn.close()
    out[body["seed"]] = (r.status, data, time.perf_counter() - t0)


def serve_requests(args, run_batch, logger, bodies: list) -> dict:
    """``runners.serve.start_server`` around ``run_batch`` (its warm-up
    batch captures the graphs), served from a thread on the ephemeral
    port: /healthz, then ``bodies`` POSTed to /generate all at once. The
    launch counters are zeroed after the warm-up. Returns the responses by
    seed, the padded batches the batcher dispatched and their handles,
    the warm-up and request walls, /healthz's JSON and the counts."""
    import http.client

    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.runners import serve

    import io

    groups, handles, spans, dispatch = [], [], [], run_batch.dispatch_batch

    def recording(reqs):
        groups.append(list(reqs))
        t = time.perf_counter()
        handles.append(dispatch(reqs))
        spans.append((t, time.perf_counter()))
        return handles[-1]

    run_batch.dispatch_batch = recording
    # the server's log lines (HTTP, repellency steps) stay out of stdout
    quiet = contextlib.redirect_stdout(io.StringIO())
    quiet.__enter__()
    t0 = time.perf_counter()
    batcher, server = serve.start_server(args, run_batch, logger)
    warm = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port, out = server.server_address[1], {}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        posts = [threading.Thread(target=_post_generate,
                                  args=(port, body, out)) for body in bodies]
        t0 = time.perf_counter()
        for t in posts:
            t.start()
        for t in posts:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=60)
        run_batch.dispatch_batch = dispatch
        quiet.__exit__(None, None, None)
    if any(t.is_alive() for t in posts) or len(out) != len(bodies):
        fail(f"serve: {len(out)} of {len(bodies)} requests answered")
    return {"out": out, "groups": groups, "handles": handles, "warm": warm,
            "wall": wall, "health": health, "counts": counts,
            "dispatch_s": [(round(a - t0, 3), round(b - t0, 3))
                           for a, b in spans]}


def _served_images(res: dict, side: int, what: str) -> dict:
    """The served PNGs decoded, by seed; fails on an error response, a
    wrong size or non-finite latents or images in a served batch."""
    from safe_denoiser_tpu_torch.data.images import decode_png

    imgs = {}
    for seed, (status, data, _) in res["out"].items():
        if status != 200:
            fail(f"{what}: request {seed} answered {status}: {data}")
        imgs[seed] = decode_png(base64.b64decode(data["image_png_base64"]))
        if imgs[seed].shape != (side, side, 3):
            fail(f"{what}: image {imgs[seed].shape}")
    for h in res["handles"]:
        if not bool(torch.isfinite(h.latents).all()
                    and torch.isfinite(h.image).all()):
            fail(f"{what}: non-finite latents or images in a batch")
    secs = sorted(v[2] for v in res["out"].values())
    stages = [{k: round(v, 2) for k, v in h.stage_ms.items()}
              for h in res["handles"]]
    print(f"{what}: warm-up batch (capture) {res['warm']:.3f} s; "
          f"{len(imgs)} concurrent requests answered in {res['wall']:.3f} "
          f"s: s a request {[round(v, 3) for v in secs]} images_per_s="
          f"{len(imgs) / res['wall']:.4f}; batches "
          f"{[[r.seed for r in g] for g in res['groups']]} with stage ms "
          f"{stages}, dispatched at s {res['dispatch_s']}; /healthz "
          f"{json.dumps(res['health'])}")
    return imgs


def phase_serve(pipe, assets: dict) -> dict:
    """9: the server at full SD-v1.4 width on the checkpoint of ``assets``
    (``runners.serve``'s parse_args and build functions, as its main composes
    them), kernel_fast from configs/nudity/safe_denoiser.yaml against a
    cached random [515,4,64,64] bank (beta calibrated on the GPU),
    std_rep, batch SERVE_BATCH: SERVE_REQUESTS concurrent requests, each
    PNG equal to phase 4's pipeline's ``generate_batch`` over the batch the
    server formed; then the deployment bundle (--export_aot through
    ``main``, --aot_bundle: equal to the live batch; other steps and
    another task YAML refused). Returns the requests' launch counts."""
    import numpy as np

    from safe_denoiser_tpu_torch.pipeline import ERASE_SPECS
    from safe_denoiser_tpu_torch.runners import serve
    from safe_denoiser_tpu_torch.runners.common import (build_pipeline,
                                                        build_repellency)
    from safe_denoiser_tpu_torch.serving import GenRequest
    from safe_denoiser_tpu_torch.utils.logging import Logger

    tmp, ckpt = assets["tmp"], assets["ckpt"]
    lat = pipe.unet.config.sample_size                  # 64: 512^2 images
    side = lat * pipe.vae_scale_factor
    g = torch.Generator(device="cuda").manual_seed(12)
    refs = torch.randn(515, 4, lat, lat, device="cuda", generator=g)
    proj = os.path.join(tmp, "serve_proj.pt")
    torch.save((refs / refs.norm(dim=1, keepdim=True)).cpu(), proj)
    del refs
    tasks = {}
    for name, scale in (("a", 0.33), ("b", 0.2)):
        tasks[name] = os.path.join(tmp, f"serve_{name}.yaml")
        _task_yaml(tasks[name], "nudity/safe_denoiser.yaml",
                   {"proj_ref_path": proj, "scale": scale,
                    "proj_noisy_ref_path_for_beta": None},
                   {"root": os.path.join(tmp, "unused")})
    save = os.path.join(tmp, "serve")
    os.makedirs(save)
    argv = ["--model_dir", ckpt, "--erase_id", "std_rep", "--batch_size",
            str(SERVE_BATCH), "--port", "0", "--max_delay_ms",
            str(SERVE_DELAY_MS), "--image_length", str(side), "--save-dir",
            save, "--device", "cuda"]
    args = serve.parse_args(argv + ["--task_config", tasks["a"]])
    logger = Logger(os.path.join(save, "serve_logs.txt"))
    spec = ERASE_SPECS[args.erase_id]
    t0 = time.perf_counter()
    served = build_pipeline(args, logger)
    proc, _ = build_repellency(args, served, logger)
    run_batch = serve.build_generate_fn(args, served, proc, spec, logger)
    print(f"serve: checkpoint loaded and bank calibrated in "
          f"{time.perf_counter() - t0:.1f} s (beta threshold "
          f"{proc.beta_threshold:.4g})")
    bodies = [{"prompt": PROMPTS[i % len(PROMPTS)], "seed": 400 + i,
               "guidance_scale": 7.5 if i % 2 == 0 else 5.0}
              for i in range(SERVE_REQUESTS)]
    res = serve_requests(args, run_batch, logger, bodies)
    imgs = _served_images(res, side, "serve sd14")
    problems = []
    if res["health"] != {"status": "ok", "batch_size": SERVE_BATCH}:
        problems.append(f"/healthz {res['health']}")
    if sorted(len({r.seed for r in grp}) for grp in res["groups"]) != \
            [SERVE_REQUESTS - SERVE_BATCH, SERVE_BATCH]:
        problems.append("not one full batch and one padded batch")
    kw = dict(num_inference_steps=50, height=side, width=side,
              repellency_processor=proc, erase_spec=spec)
    for grp in res["groups"]:
        want = pipe.generate_batch([r.prompt for r in grp],
                                   [r.seed for r in grp],
                                   [r.guidance_scale for r in grp], **kw)
        # a request is answered from its own row; the padding rows repeat
        # the last request, and in bf16 a row's bits depend on its place
        # in the batch (the GEMMs' tiling), so only the first is compared
        for row, r in enumerate(grp):
            if grp.index(r) == row and not np.array_equal(imgs[r.seed],
                                                          want[row]):
                problems.append(f"request {r.seed} differs from "
                                "generate_batch")
    want = runner_launches(pipe, len(res["groups"]), 10, batch=SERVE_BATCH)
    if problems:
        fail("serve sd14: " + "; ".join(problems))
    check_launches(res["counts"], want, "serve sd14")

    path = os.path.join(tmp, "serve_bundle.sdt")
    _run_quiet(serve.main, argv + ["--task_config", tasks["a"],
                                   "--export_aot", path])
    run_aot = serve.build_aot_generate_fn(serve.parse_args(
        argv + ["--task_config", tasks["a"], "--aot_bundle", path]),
        served, proc, spec, logger)
    reqs = [GenRequest(**b) for b in bodies[:SERVE_BATCH]]
    same = all(np.array_equal(a, b)
               for a, b in zip(run_aot(reqs), run_batch(reqs)))
    refused = {}
    for what, task, extra in (("steps", tasks["a"],
                               ["--num_inference_steps", "40"]),
                              ("task YAML", tasks["b"], [])):
        other = serve.parse_args(argv + ["--task_config", task,
                                         "--aot_bundle", path, *extra])
        try:
            serve.build_aot_generate_fn(
                other, served, build_repellency(other, served, logger)[0],
                spec, logger)
            refused[what] = None
        except SystemExit as e:
            refused[what] = str(e)[:90]
    print(f"serve sd14 bundle: {os.path.getsize(path)} bytes; its batch "
          f"equal to the live one: {same}; refused: {json.dumps(refused)}")
    if not same or not all(refused.values()):
        fail("serve sd14 bundle: the bundle's batch differs from the live "
             "one, or a mismatched server was not refused")
    served._graphs.release()
    return {"serve sd14": res["counts"]}


def phase_serve_sd3(tmp: str, ckpt: str, task: str) -> dict:
    """9 (SD3): ``runners.serve --sd3`` on phase 8's checkpoint in bf16,
    std_rep with phase 8's kernel_fast task YAML, batch
    SD3_SERVE_REQUESTS: that many concurrent requests at 1024^2, finite;
    launch counts from the gates (B1 per block and step, B2 per step in
    std_rep's window, the decode of the batch)."""
    from safe_denoiser_tpu_torch.models.weights import load_component_config
    from safe_denoiser_tpu_torch.pipeline import ERASE_SPECS
    from safe_denoiser_tpu_torch.runners import serve
    from safe_denoiser_tpu_torch.schedulers.flow_match import (
        FlowMatchEulerScheduler, flow_match_config_from_checkpoint)
    from safe_denoiser_tpu_torch.utils.logging import Logger

    save = os.path.join(tmp, "serve_sd3")
    os.makedirs(save)
    args = serve.parse_args([
        "--sd3", "--model_dir", ckpt, "--task_config", task, "--erase_id",
        "std_rep", "--batch_size", str(SD3_SERVE_REQUESTS), "--port", "0",
        "--max_delay_ms", str(SERVE_DELAY_MS), "--image_length",
        str(SD3_SIDE), "--save-dir", save, "--device", "cuda"])
    logger = Logger(os.path.join(save, "serve_logs.txt"))
    t0 = time.perf_counter()
    run_batch = serve.build_run_batch(args, logger)
    print(f"serve sd3: checkpoint loaded and bank encoded in "
          f"{time.perf_counter() - t0:.1f} s")
    bodies = [{"prompt": PROMPTS[i], "seed": 500 + i}
              for i in range(SD3_SERVE_REQUESTS)]
    res = serve_requests(args, run_batch, logger, bodies)
    _served_images(res, SD3_SIDE, "serve sd3")
    window = ERASE_SPECS[args.erase_id].window
    ts, _ = FlowMatchEulerScheduler(flow_match_config_from_checkpoint(
        os.path.join(ckpt, "scheduler"))).timesteps_and_sigmas(SD3_STEPS)
    vcfg = load_component_config(os.path.join(ckpt, "vae"), "vae")
    side = SD3_SIDE // 2 ** (len(vcfg.block_out_channels) - 1)
    n = len(res["groups"])
    want = {**attention_launches(
        "bhsd", n * SD3_RUNNER_LAYERS["mmdit"] * SD3_STEPS),
        "rbf": n * sum(bool(window.mask(i, float(t)))
                       for i, t in enumerate(ts)),
        **adaln_launches(SD3_RUNNER_LAYERS["mmdit"], n * SD3_STEPS),
        **{k: n * v for k, v in vae_kernel_plan(
            vcfg, SD3_SERVE_REQUESTS, side, side)[0].items()}}
    check_launches(res["counts"], want, "serve sd3")
    return {"serve sd3": res["counts"]}


def profile_call(fn, label: str) -> None:
    """torch.profiler over ``fn()`` (which ends in a device sync): device
    time by kernel, this port's kernels against the rest, and the device's
    busy share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and ev.device_type.name == "CUDA":
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    # attn_kernel: the attention core of B1, B9 and B10 (one kernel name;
    # the layout switches say which ran); attn_i8_kernel: its int8 form,
    # and quantize_i8_kernel B8's quantize pass; conv_kernel: the conv
    # core, B3 in its upsample form (<true>), B4 in its nine-tap form
    # (<false>), matched demangled or mangled; up4_kernel: its interleave
    # form (B7); rbf_: B2's two kernels; gn_fused_kernel: B6
    names = {"attn_kernel": ("attn_kernel",),
             "attn_i8_kernel": ("attn_i8_kernel",),
             "quantize_i8_kernel": ("quantize_i8_kernel",),
             "repack_kernel": ("repack_kernel",), "rbf_": ("rbf_",),
             "conv_kernel<true>": ("conv_kernel<true>", "conv_kernelILb1E"),
             "up4_kernel": ("up4_kernel",),
             "conv_kernel<false>": ("conv_kernel<false>", "conv_kernelILb0E"),
             "_partial_sums": ("_partial_sums",), "_finish": ("_finish",),
             "gn_fused_kernel": ("gn_fused_kernel",)}
    ours = dict.fromkeys(names, 0.0)
    for ms, _, key in rows:
        for k, pats in names.items():
            if any(pat in key for pat in pats):
                ours[k] += ms
    print(f"profile ({label}): wall_ms={wall_ms:.1f} "
          f"device_busy_ms={busy:.1f} busy_share={busy / wall_ms:.3f} "
          f"idle_share={1 - busy / wall_ms:.3f}")
    print(f"profile ({label}) port kernels ms: " + json.dumps(
        {k: round(v, 3) for k, v in ours.items()}))
    for ms, n, key in rows[:20]:
        print(f"  profile {ms:10.3f} ms {n:6d}x {key[:100]}")


# phase 10, the training slice: SD-v1.4 at batch 1, 512^2 (64^2 latents),
# 3 iterations; the concept and the LoRA rank; the SD3 flow-matching LoRA
# run (10b): its steps, rank and targets (the attention projections of
# both streams, the flax paths' "attn_" kernels)
TRAIN_ITERS, TRAIN_SIDE, TRAIN_PROMPT, TRAIN_LORA_RANK = 3, 512, "nudity", 4
# UNet forwards of an ESD iteration: the x_t draw's 3 CFG steps (batch 2),
# the frozen teacher (batch 2), the student (batch 1, with its backward)
TRAIN_FORWARDS = 5
FLOW_STEPS, FLOW_RANK, FLOW_TARGETS = 2, 4, "attn_"
# the card-vs-CPU gradient check (``phase_grad_check``): cosine floor and
# max|card - cpu| / max|cpu| ceiling of each parameter group. The card
# computes in bf16 through the kernels (B1/B1b, B5/B5b, B3/B3b), the CPU
# in f32 through the plain versions: bf16 rounding through the UNet and
# back read cosines >= 0.99988 and max|d|/max|cpu| <= 1.42e-2 in every
# group on an H100 (two weight draws); the bounds sit ~3.5x outside that
# relative error. A B1b without its Delta term read 0.509 / 1.82 in the
# q/k group, a B3b-dw without tap (0, 0) 0.943 / 1.0 in its group: both
# fail (readings in PERF.md)
GRAD_COS_MIN, GRAD_REL_MAX = 0.999, 0.05


def unet_kernel_counts(cfg, h: int, w: int) -> dict:
    """B1, B5 and B3 launches of one bf16 UNet forward at h x w latents,
    from the routing gates: self-attentions that ``attention.supports``
    takes, the statistics kernel's GroupNorms (``unet_gn_launches``), the
    upsamples that ``conv3x3.supports_up`` takes."""
    from safe_denoiser_tpu_torch.ops import attention
    from safe_denoiser_tpu_torch.ops import conv3x3 as c3

    chans, heads = list(cfg.block_out_channels), cfg.num_attention_heads
    n, t = len(chans), cfg.transformer_layers

    def takes(level: int, ch: int) -> bool:
        s = (h >> level) * (w >> level)
        return attention.supports(s, s, ch // heads)

    attn = sum(cfg.layers_per_block * t for i in range(n - 1)
               if takes(i, chans[i]))
    attn += t if takes(n - 1, chans[-1]) else 0
    rev = chans[::-1]
    attn += sum((cfg.layers_per_block + 1) * t for i in range(1, n)
                if takes(n - 1 - i, rev[i]))
    up = sum(1 for i in range(n - 1)
             if c3.supports_up((1, h >> (n - 1 - i), w >> (n - 1 - i),
                                rev[i]), rev[i], rev[i]))
    return {"attention": attn,
            "gn_stats": unet_gn_launches(cfg, h, w)["gn_stats"],
            "conv3x3_up": up}


def _train_losses(log_dir: str) -> list:
    import re
    with open(os.path.join(log_dir, "train_logs.txt")) as f:
        return [float(m.group(1)) for m in
                re.finditer(r"iter \d+: loss (\S+)", f.read())]


def _all_counts() -> dict:
    from safe_denoiser_tpu_torch import ops
    return {**ops.launch_counts(), **ops.backward_launch_counts()}


def _grad_groups(names, cfg, h: int, w: int) -> dict:
    """The gradient check's parameter groups: the self-attention q/k and
    v/out projections where B1 runs (their gradients come through B1b's dQ,
    dK and dV), the upsample conv on B3 (B3b-dw), and every parameter."""
    from safe_denoiser_tpu_torch.ops import attention

    chans, heads, n = (list(cfg.block_out_channels), cfg.num_attention_heads,
                       len(cfg.block_out_channels))

    def on_b1(name: str) -> bool:
        parts = name.split(".")
        if parts[0] == "down_blocks":
            level, ch = int(parts[1]), chans[int(parts[1])]
        elif parts[0] == "up_blocks":
            level, ch = n - 1 - int(parts[1]), chans[n - 1 - int(parts[1])]
        else:
            level, ch = n - 1, chans[-1]
        s = (h >> level) * (w >> level)
        return attention.supports(s, s, ch // heads)

    return {
        "B1b q/k": [m for m in names if (".attn1.to_q." in m
                                         or ".attn1.to_k." in m)
                    and on_b1(m)],
        "B1b v/out": [m for m in names if (".attn1.to_v." in m
                                           or ".attn1.to_out." in m)
                      and on_b1(m)],
        "B3b-dw": [m for m in names
                   if m.startswith("up_blocks.2.upsamplers.0.conv.")],
        "all": list(names),
    }


def phase_grad_check(unet_cpu=None) -> dict:
    """The gradient of one ESD loss at full SD-v1.4 width, batch 1, 64^2
    latents, with respect to every UNet weight: on the card in bf16 through
    the kernels (B1/B1b, B5/B5b, B3/B3b) against the CPU in f32 through the
    plain versions, on the same f32 weights and inputs. The student's term
    ``mean((e_theta(x_t, t, c) - target)^2)`` with an injected target (the
    frozen teacher's forwards carry no gradient). ``unet_cpu``: the f32
    weights (a seeded random UNet when None). Per group (``_grad_groups``):
    cosine similarity and max|card - cpu| / max|cpu|, held to GRAD_COS_MIN
    and GRAD_REL_MAX."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.models import SD14_UNET, UNet2DConditionModel
    from safe_denoiser_tpu_torch.training.esd import module_apply_fn

    cfg = SD14_UNET
    lat = TRAIN_SIDE // 8
    if unet_cpu is None:
        torch.manual_seed(5)
        unet_cpu = UNet2DConditionModel(cfg)
    g = torch.Generator().manual_seed(6)
    x_t = torch.randn(1, 4, lat, lat, generator=g)
    ctx = torch.randn(1, 77, cfg.cross_attention_dim, generator=g)
    target = torch.randn(1, 4, lat, lat, generator=g)
    t = torch.tensor([500])
    unet_gpu = UNet2DConditionModel(cfg).cuda()
    unet_gpu.load_state_dict(unet_cpu.state_dict())
    grads = {}
    for dev, module, dtype in (("cuda", unet_gpu, torch.bfloat16),
                               ("cpu", unet_cpu, torch.float32)):
        params = {n: p.detach().clone().requires_grad_()
                  for n, p in module.named_parameters()}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        pred = module_apply_fn(module, dtype)(params, x_t.to(dev), t.to(dev),
                                              ctx.to(dev))
        loss = torch.mean(torch.square(pred.float() - target.to(dev)))
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = _all_counts()
        grads[dev] = {n: p.grad.float().cpu() for n, p in params.items()}
        print(f"gradient check: {dev} loss {loss.item():.6f} in "
              f"{time.perf_counter() - t0:.1f} s")
        del params, pred, loss
    per = unet_kernel_counts(cfg, lat, lat)
    check_launches(counts, {
        "attention": per["attention"], "gn_stats": per["gn_stats"],
        "conv3x3_up": per["conv3x3_up"],
        "attention_bwd": per["attention"], "gn_stats_bwd": per["gn_stats"],
        "conv3x3_up_bwd_dx": per["conv3x3_up"],
        "conv3x3_up_bwd_dw": per["conv3x3_up"]}, "gradient check")
    out, bad = {}, []
    for name, members in _grad_groups(list(grads["cpu"]), cfg, lat,
                                      lat).items():
        if not members:
            continue
        a = torch.cat([grads["cuda"][m].reshape(-1) for m in members])
        b = torch.cat([grads["cpu"][m].reshape(-1) for m in members])
        cos = (torch.dot(a.double(), b.double())
               / (a.double().norm() * b.double().norm())).item()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        out[name] = (cos, rel)
        print(f"gradient check {name} ({len(members)} tensors, "
              f"{b.numel()} values): cosine {cos:.6f} max|d|/max|cpu| "
              f"{rel:.4e} (bounds {GRAD_COS_MIN}, {GRAD_REL_MAX})")
        if not (cos >= GRAD_COS_MIN and rel <= GRAD_REL_MAX):
            bad.append(name)
    del unet_gpu
    torch.cuda.empty_cache()
    if bad:
        fail(f"gradient check: the card's gradient leaves the CPU's in "
             f"{bad}")
    return out


def phase_train_timing(unet, ctx_c, ctx_u) -> None:
    """One noxattn ESD iteration at full width on ``unet``'s f32 master
    weights, timed by part with CUDA events (after 2 warm-up iterations,
    the mean of 3): the x_t draw, the frozen teacher, the student's
    forward and backward, the optimizer."""
    from safe_denoiser_tpu_torch.schedulers import DDPMScheduler
    from safe_denoiser_tpu_torch.training import (ESDConfig, esd_param_mask,
                                                  make_optimizer,
                                                  sample_xt_for_esd)
    from safe_denoiser_tpu_torch.training.esd import module_apply_fn

    lat = TRAIN_SIDE // 8
    params = {n: p.detach().clone() for n, p in unet.named_parameters()}
    frozen = {n: p.to(torch.bfloat16) for n, p in params.items()}
    opt = make_optimizer(ESDConfig(), params,
                         esd_param_mask(params, "noxattn"))
    apply_fn = module_apply_fn(unet, torch.bfloat16)
    sch = DDPMScheduler()
    gen = torch.Generator(device="cuda").manual_seed(0)
    parts = ("draw", "teacher", "student", "optimizer")
    ms = {k: [] for k in parts}
    for it in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        x_t, t = sample_xt_for_esd(apply_fn, frozen, sch, ctx_c, ctx_u, gen,
                                   (1, 4, lat, lat))
        ev[1].record()
        with torch.no_grad():
            e = apply_fn(frozen, torch.cat([x_t, x_t]), torch.cat([t, t]),
                         torch.cat([ctx_c, ctx_u])).float()
        target = e[1:] - (e[:1] - e[1:])
        ev[2].record()
        opt.zero_grad(set_to_none=True)
        loss = torch.mean(torch.square(
            apply_fn(params, x_t, t, ctx_c).float() - target))
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        if it >= 2:
            for k, name in enumerate(parts):
                ms[name].append(ev[k].elapsed_time(ev[k + 1]))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    print("training iteration (noxattn, batch 1, 512^2, bf16, device ms): "
          + " ".join(f"{k}={v:.2f}" for k, v in mean.items())
          + f" total={sum(mean.values()):.2f}")
    del params, frozen, opt


def phase_training(assets: dict) -> dict:
    """Phase 10: ``runners.train_esd`` at full SD-v1.4 width on phase 6's
    checkpoint (noxattn, 3 iterations, batch 1, 512^2, a snapshot at 2),
    the same run resumed from iteration 2 (bit for bit), a LoRA run
    (rank 4, xattn, the adapter saved), ``runners.edit_concepts`` (RECE);
    checks the losses, the changed subsets, the export through
    ``load_unet_state_dict``, ``load_lora`` against the in-memory merge,
    the launches of B1/B1b, B5/B5b and B3/B3b per iteration; times an
    iteration by part; holds the card's gradient against the CPU's.
    Returns the launch counts of its runs."""
    from safe_denoiser_tpu_torch.models import SD14_UNET
    from safe_denoiser_tpu_torch.models.weights import load_safetensors
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    from safe_denoiser_tpu_torch.runners import edit_concepts, train_esd
    from safe_denoiser_tpu_torch.training import (cross_attn_kv_paths,
                                                  esd_param_mask)

    ckpt = assets["ckpt"]
    root = os.path.join(assets["tmp"], "train")
    lat = TRAIN_SIDE // 8
    per = unet_kernel_counts(SD14_UNET, lat, lat)
    its = TRAIN_ITERS
    fwd = {k: TRAIN_FORWARDS * its * per[k] for k in per}
    base = ["--model_dir", ckpt, "--prompt", TRAIN_PROMPT, "--batch_size",
            "1", "--image_length", str(TRAIN_SIDE), "--log_every", "1",
            "--iterations", str(its), "--device", "cuda"]
    totals = []

    def run(what, main, argv, want=None):
        from safe_denoiser_tpu_torch import ops
        out_dir = os.path.join(root, what)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = main(argv + ["--save-dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_counts()
        print(f"training phase {what}: {wall:.1f} s (checkpoint load "
              f"included), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if want is not None:
            check_launches(counts, want, f"training phase {what}")
        totals.append(counts)
        return res, out_dir

    # full noxattn fine-tune with a snapshot at iteration 2
    esd = os.path.join(root, "esd.safetensors")
    trained, log_dir = run("noxattn", train_esd.main, base + [
        "--train_method", "noxattn", "--save_every", "2", "--save_path", esd],
        {**fwd, "attention_bwd": its * per["attention"],
         "gn_stats_bwd": its * per["gn_stats"],
         "conv3x3_up_bwd_dx": its * per["conv3x3_up"],
         "conv3x3_up_bwd_dw": its * per["conv3x3_up"]})
    losses = _train_losses(log_dir)
    print(f"training noxattn losses: {losses}")
    if len(losses) != its or not all(math.isfinite(x) for x in losses):
        fail(f"training noxattn: losses {losses}")
    exported = load_safetensors(esd)
    pipe = SafeDiffusionPipeline.from_pretrained(ckpt, device="cuda",
                                                 dtype=torch.float32)
    orig = {k: v.detach().clone() for k, v in pipe.unet.state_dict().items()}
    pipe.load_unet_state_dict(esd)
    mask = esd_param_mask(orig, "noxattn")
    changed = {k for k in orig if not torch.equal(exported[k],
                                                  orig[k].cpu())}
    if not (all(torch.equal(v, trained[k]) for k, v in
                pipe.unet.state_dict().items())
            and changed and all(mask[k] for k in changed)):
        fail("training noxattn: the export does not equal the trained "
             "module through load_unet_state_dict, or a frozen weight "
             "moved")
    print(f"training noxattn: {len(changed)} of {sum(mask.values())} "
          f"trainable tensors changed, none of the "
          f"{len(mask) - sum(mask.values())} frozen; the export loads back "
          "bit for bit")
    run("resume", train_esd.main, base + [
        "--train_method", "noxattn", "--save_every", "2", "--resume",
        "--save_path", esd],
        {k: v // its for k, v in fwd.items()} | {
            "attention_bwd": per["attention"],
            "gn_stats_bwd": per["gn_stats"],
            "conv3x3_up_bwd_dx": per["conv3x3_up"],
            "conv3x3_up_bwd_dw": per["conv3x3_up"]})
    resumed = load_safetensors(esd)
    if not all(torch.equal(resumed[k], exported[k]) for k in exported):
        fail("training: the run resumed at iteration 2 differs from the "
             "uninterrupted one")
    print("training resume: iteration 2 onward from the snapshot equals "
          "the uninterrupted run bit for bit")
    del trained, exported, resumed

    # LoRA on the cross-attention: the first self-attention runs before any
    # trained weight, so it needs no backward; the upsample conv's weight
    # is frozen (no dW)
    lora_path = os.path.join(root, "lora_merged.safetensors")
    adapter = os.path.join(root, "adapter.safetensors")
    merged, log_dir = run("lora", train_esd.main, base + [
        "--lora_rank", str(TRAIN_LORA_RANK), "--lora_targets", "xattn",
        "--save_path", lora_path, "--save_lora_path", adapter],
        {**fwd, "attention_bwd": its * max(per["attention"] - 1, 0),
         "gn_stats_bwd": its * per["gn_stats"],
         "conv3x3_up_bwd_dx": its * per["conv3x3_up"],
         "conv3x3_up_bwd_dw": 0})
    losses = _train_losses(log_dir)
    print(f"training lora losses: {losses}")
    exported = load_safetensors(lora_path)
    changed = {k for k in orig if not torch.equal(exported[k],
                                                  orig[k].cpu())}
    pipe.unet.load_state_dict(orig)
    pipe.load_lora(adapter)
    if (len(losses) != its or not all(math.isfinite(x) for x in losses)
            or not changed or any("attn2" not in k for k in changed)
            or not all(torch.equal(v.cpu(), exported[k]) for k, v in
                       pipe.unet.state_dict().items())):
        fail("training lora: non-finite losses, a weight outside attn2 "
             "changed, or load_lora differs from the in-memory merge")
    print(f"training lora: {len(changed)} attn2 tensors changed; "
          "load_lora of the saved adapter equals the merge bit for bit")
    del merged, exported

    rece = os.path.join(root, "rece.safetensors")
    t0 = time.perf_counter()
    run("rece", edit_concepts.main, [
        "--model_dir", ckpt, "--method", "rece", "--erase", "nudity",
        "--preserve", "a person", "--save_path", rece, "--device", "cuda"],
        {k: 0 for k in totals[0]})
    edited = load_safetensors(rece)
    changed = {k for k in orig if not torch.equal(edited[k], orig[k].cpu())}
    if changed != set(cross_attn_kv_paths(orig)) or not all(
            bool(torch.isfinite(v).all()) for v in edited.values()):
        fail("rece: edited weights other than attn2 to_k/to_v, or "
             "non-finite ones")
    print(f"rece: {len(changed)} cross-attention K/V weights edited in "
          f"{time.perf_counter() - t0:.1f} s (checkpoint load included)")

    pipe.unet.load_state_dict(orig)
    emb = pipe.encode_prompt(TRAIN_PROMPT)
    phase_train_timing(pipe.unet, emb[1], emb[0])
    unet_cpu = pipe.unet.float().cpu()
    del pipe, orig
    torch.cuda.empty_cache()
    phase_grad_check(unet_cpu)
    return {k: sum(c[k] for c in totals) for k in totals[0]}


def phase_sd3_flow_lora(ckpt: str) -> dict:
    """10b: SD3 flow matching under LoRA on phase 8's checkpoint (MMDiT at
    1536 wide, depth cut to 6), 1024^2 (4096 patches + 333 text tokens:
    B1/B1b at [1,4429,24,64] with the tail mask), batch 1, FLOW_STEPS
    steps of ``make_lora_train_step(flow_matching_loss, ...)``. Checks the
    losses, that the adapter moved, and B1/B1b launches."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.models import MMDiT
    from safe_denoiser_tpu_torch.models.weights import (
        load_component_config, load_sharded_state_dict)
    from safe_denoiser_tpu_torch.training import (
        ESDConfig, flow_matching_loss, init_lora_params,
        make_lora_train_step, make_optimizer, sample_sigmas_logit_normal)
    from safe_denoiser_tpu_torch.training.esd import module_apply_fn

    tdir = os.path.join(ckpt, "transformer")
    cfg = load_component_config(tdir, "mmdit")
    tf = MMDiT(cfg)
    tf.load_state_dict(load_sharded_state_dict(tdir))
    tf = tf.cuda()
    params = dict(tf.named_parameters())
    for p in params.values():
        p.requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lora = init_lora_params(params, gen, FLOW_RANK, FLOW_TARGETS,
                            model_cfg=cfg)
    conf = ESDConfig(learning_rate=1e-4)
    apply_fn = module_apply_fn(tf, torch.bfloat16)
    step = make_lora_train_step(
        lambda merged, *b: flow_matching_loss(apply_fn, merged, *b), conf,
        1.0, model_cfg=cfg)
    opt = make_optimizer(conf, lora)
    side = SD3_SIDE // 8
    x0 = torch.randn(1, cfg.in_channels, side, side, generator=gen,
                     device="cuda")
    ctx = torch.randn(1, 333, cfg.joint_attention_dim, generator=gen,
                      device="cuda")
    pooled = torch.randn(1, cfg.pooled_projection_dim, generator=gen,
                         device="cuda")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(FLOW_STEPS):
        sigma = sample_sigmas_logit_normal(gen, 1)
        noise = torch.randn(x0.shape, generator=gen, device="cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, _, loss = step(lora, opt, params, x0, ctx, pooled, sigma, noise)
        end.record()
        torch.cuda.synchronize()
        losses.append(loss.item())
        ms.append(start.elapsed_time(end))
    counts = _all_counts()
    still = [p for p, ab in lora.items() if not bool(ab["b"].abs().max() > 0)]
    print(f"sd3 flow lora: {len(lora)} adapted kernels, rank {FLOW_RANK}; "
          f"losses {losses}; step ms {[round(v, 2) for v in ms]}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{len(lora) - len(still)} adapters moved, still: {still} (the "
          "last block's text stream ends at its attention, so its text "
          "queries get no gradient)")
    # adaln in the forwards (AdaLN's backward is plain PyTorch)
    check_launches(counts, {"attention": FLOW_STEPS * cfg.num_layers,
                            "attention_bwd": FLOW_STEPS * cfg.num_layers,
                            **adaln_launches(cfg.num_layers, FLOW_STEPS)},
                   "sd3 flow lora")
    last = f"blocks_{cfg.num_layers - 1}/attn_add_q/"
    if not (all(math.isfinite(x) for x in losses)
            and all(last in p for p in still)):
        fail("sd3 flow lora: non-finite loss or an adapter that did not "
             "move")
    del tf, params, lora, opt
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------- phase 11
# bounds of phase 11, stated before its first run on the card: rows of a
# data-mesh slot equal its sub-batch's generate_batch bit for bit; with the
# beta gate closed the bank-sharded latents equal the replicated bank's
# (the score is not used); elsewhere a bf16 result within PAR_REL_BOUND of
# the largest |value| of the unsharded run (f32 partial sums in another
# order, B1 against the plain attention under SP, a batch of 1 under PP:
# bf16 roundings that a step amplifies)
PAR_REL_BOUND = 0.05
# the SD3 runs: SD3-medium's widths at 6 of its 24 blocks, 5 flow-match
# steps at 1024^2, CFG 2.5, kernel_fast (channel-normalized x, no gate,
# sigma 1) in [1000, 780] against a 16-latent bank
PAR_SD3_LAYERS, PAR_SD3_STEPS = 6, 5


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _check_rel(what: str, got, want, bound: float = PAR_REL_BOUND) -> float:
    err = _rel(got, want)
    print(f"{what}: max|d|/max|unsharded|={err:.3e} bound {bound:.0e}")
    if not (bool(torch.isfinite(got).all()) and err <= bound):
        fail(f"{what}: {err:.3e} above its bound {bound:.0e}")
    return err


def slots_text(devs) -> str:
    """"2 cuda:0 slots" or "slots cuda:0, cuda:1"."""
    names = [str(d) for d in devs]
    if len(set(names)) == 1:
        return f"{len(names)} {names[0]} slots"
    return "slots " + ", ".join(names)


def phase_parallel_sd14(pipe, kw, gate, devices=None) -> dict:
    """sd14-mesh: phase 4's batch (4 x 512^2, 50 steps, kernel_fast against
    the 515-row bank) on a data mesh of 2 slots, each slot's rows against
    generate_batch on its 2-row sub-batch; the bank sharded over 4 slots
    on a 2-row batch (B2 4 x the in-window steps); phase 5's gate batches
    on that bank; unet-tp: one UNet forward over 2 model slots. The slots
    are the first of ``devices`` (default: 4 on the pipeline's device)."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.parallel import (UNET_TP_RULES, make_mesh,
                                                  shard_params_tp)
    from safe_denoiser_tpu_torch.parallel.tp import clear_tp
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    import numpy as np

    dev = pipe.device
    devices = devices or [torch.device("cuda", 0)] * 4
    counts = {}

    def twin():
        return SafeDiffusionPipeline(pipe.unet, pipe.vae, pipe.text_encoder,
                                     pipe.tokenizer, pipe.scheduler,
                                     device=dev)

    seeds = [0, 1, 2, 3]
    mesh_pipe = twin()
    mesh_pipe.enable_data_mesh(mesh=make_mesh(devices=devices[:2]))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pending = mesh_pipe.dispatch_batch(PROMPTS, seeds=seeds,
                                       num_inference_steps=50, **kw)
    rows = pending.fetch()
    wall = time.perf_counter() - t0
    counts["sd14-mesh"] = ops.launch_counts()
    st = pending.stage_ms
    print(f"sd14-mesh: 4 x 512^2 over {slots_text(devices[:2])}, 50 steps: "
          f"{json.dumps({k: round(v, 2) for k, v in st.items()})} "
          f"wall_s={wall:.3f} (captures included)")
    check_launches(counts["sd14-mesh"],
                   runner_launches(pipe, 2, 11, batch=2), "sd14-mesh")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    again = mesh_pipe.dispatch_batch(PROMPTS, seeds=seeds,
                                     num_inference_steps=50, **kw)
    again.fetch()
    print(f"sd14-mesh replay: "
          f"{json.dumps({k: round(v, 2) for k, v in again.stage_ms.items()})}"
          f" wall_s={time.perf_counter() - t0:.3f}")
    # each slot's rows against generate_batch on its sub-batch (the same
    # program at batch 2: under bf16 a row depends on its batch)
    subs = []
    for lo in (0, 2):
        sub = pipe.dispatch_batch(PROMPTS[lo:lo + 2], seeds=seeds[lo:lo + 2],
                                  num_inference_steps=50,
                                  **{**kw, "guidance_scales": [7.5] * 2})
        images = sub.fetch()
        subs.append((sub, images))
        for k in range(2):
            if not (np.array_equal(rows[lo + k], images[k]) and torch.equal(
                    pending.latents[lo + k], sub.latents[k])):
                fail(f"sd14-mesh: row {lo + k} differs from generate_batch "
                     "on its slot's sub-batch")
    print("sd14-mesh: 4 rows equal bit for bit (latents and PNG) to "
          "generate_batch on each slot's 2-row sub-batch")

    # the bank sharded over 4 slots, on the first sub-batch
    bank_pipe = twin()
    bank_pipe.enable_bank_sharding(make_mesh(devices=devices[:4]))
    ops.reset_launch_counts()
    sharded = bank_pipe.dispatch_batch(PROMPTS[:2], seeds=seeds[:2],
                                       num_inference_steps=50,
                                       **{**kw, "guidance_scales": [7.5] * 2})
    sharded.fetch()
    counts["sd14-bank-shard"] = ops.launch_counts()
    want = runner_launches(pipe, 1, 11, batch=2)
    want["rbf"] = 4 * 11
    check_launches(counts["sd14-bank-shard"], want, "sd14-bank-shard")
    ref = subs[0][0]
    if not torch.equal(sharded.applied, ref.applied):
        fail("sd14-bank-shard: the gate differs from the replicated bank's")
    if not sharded.applied.any() and not torch.equal(sharded.latents,
                                                     ref.latents):
        fail("sd14-bank-shard: with the gate closed the latents differ "
             "from the replicated bank's")
    print(f"sd14-bank-shard: 2 x 512^2, 50 steps, 515 rows over "
          f"{slots_text(devices[:4])} "
          f"(129 a shard, one PAD row): B2 {counts['sd14-bank-shard']['rbf']}"
          f" launches, gate {'open' if sharded.applied.any() else 'closed'}"
          f", latents max|d| vs replicated "
          f"{(sharded.latents.float() - ref.latents.float()).abs().max():.3e}")
    # phase 5's open gate on the sharded bank
    bank, rep_runs = gate
    runs = gate_runs(bank_pipe, bank)
    (lat_a, applied, rbf_n), (lat_b, _, _) = runs[0.33], runs[0.0]
    gap = (lat_a - lat_b).abs().max().item()
    print(f"sd14-bank-shard gate open: applied {applied.any(1).tolist()} B2 "
          f"launches {rbf_n} max|latents(0.33) - latents(0)|={gap:.4e}")
    if not (torch.equal(applied, rep_runs[0.33][1]) and rbf_n == 4
            and gap > 0):
        fail("sd14-bank-shard: the sharded score did not move the latents "
             "as the replicated one does")
    _check_rel("sd14-bank-shard gate open vs replicated", lat_a,
               rep_runs[0.33][0])

    # unet-tp: one forward of the batch-4 CFG UNet call over 2 model slots
    gen = torch.Generator(device=dev).manual_seed(11)
    side = SD14_SIDE // pipe.vae_scale_factor
    lat = torch.randn(8, 4, side, side, device=dev, generator=gen)
    ctx = torch.randn(8, 77, pipe.unet.config.cross_attention_dim,
                      device=dev, generator=gen)
    dtype = pipe.unet.conv_in.weight.dtype
    with torch.no_grad():
        want_eps = pipe.unet(lat.to(dtype), 981, ctx.to(dtype))
        mesh2 = make_mesh(devices=devices[:2], axis="model")
        shard_params_tp(pipe.unet, mesh2, rules=UNET_TP_RULES)
        try:
            ops.reset_launch_counts()
            got_eps = pipe.unet(lat.to(dtype), 981, ctx.to(dtype))
            torch.cuda.synchronize()
            counts["unet-tp"] = ops.launch_counts()
            t_tp = cuda_ms(lambda: pipe.unet(lat.to(dtype), 981,
                                             ctx.to(dtype)), reps=3)
        finally:
            clear_tp(pipe.unet)
        t_plain = cuda_ms(lambda: pipe.unet(lat.to(dtype), 981,
                                            ctx.to(dtype)), reps=3)
    print(f"unet-tp: [8,4,64,64] over model {slots_text(devices[:2])}: B1 "
          f"{counts['unet-tp']['attention']} launches (10 self-attentions x "
          f"2 slots, [8,4096,4,40] at level 0), {t_tp:.2f} ms a forward "
          f"against {t_plain:.2f} ms unsharded")
    if counts["unet-tp"]["attention"] != 20:
        fail("unet-tp: B1 did not run once per self-attention and slot")
    _check_rel("unet-tp vs unsharded", got_eps, want_eps)
    return counts, mesh_pipe, subs


def phase_parallel_sd3(devices=None) -> dict:
    """sd3-parallel: SD3-medium's widths at 6 blocks, 5 steps of
    ``sample_sd3`` (1 x 1024^2, CFG 2.5, the renoising repellency against
    16 random latents) unsharded, with the image tokens over 2 seq slots
    (SP), the blocks over 4 pipe slots in 2 microbatches (PP); the bank
    (4 copies of the run's own x0 among them) over 4 slots against the
    replicated one; one MMDiT forward over 2 model slots (TP). The slots
    are the first of ``devices`` (default: 4 on cuda:0)."""
    import dataclasses

    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.models import SD3_MEDIUM, MMDiT
    from safe_denoiser_tpu_torch.parallel import (ShardedBank, make_mesh,
                                                  shard_bank,
                                                  shard_params_tp,
                                                  shard_stacked_pp,
                                                  stack_block_params)
    from safe_denoiser_tpu_torch.parallel.tp import clear_tp
    from safe_denoiser_tpu_torch.pipeline import RepellencyWindow
    from safe_denoiser_tpu_torch.pipeline.sampler import sample_sd3
    from safe_denoiser_tpu_torch.repellency import RepellencyConfig
    from safe_denoiser_tpu_torch.schedulers import FlowMatchEulerScheduler

    dev = torch.device("cuda")
    devices = devices or [torch.device("cuda", 0)] * 4
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = dataclasses.replace(SD3_MEDIUM, num_layers=PAR_SD3_LAYERS)
    prev = torch.get_default_dtype()
    with torch.device(dev):
        torch.set_default_dtype(torch.bfloat16)
        try:
            tf = init_small_(MMDiT(cfg), gen).eval()
        finally:
            torch.set_default_dtype(prev)
    hw, c = SD3_SIDE // 8, cfg.in_channels
    lat0 = torch.randn(1, c, hw, hw, device=dev, generator=gen)
    # 77 CLIP tokens and 256 T5 tokens (4096 + 333 = 4429 joint tokens)
    ctx = torch.randn(2, 1, 333, cfg.joint_attention_dim, device=dev,
                      generator=gen)
    pooled = torch.randn(2, 1, cfg.pooled_projection_dim, device=dev,
                         generator=gen)
    refs = torch.randn(SD3_BANK, c, hw, hw, device=dev, generator=gen)
    refs = refs / refs.norm(dim=1, keepdim=True)
    noise = torch.randn(PAR_SD3_STEPS, 1, c, hw, hw, device=dev,
                        generator=gen)
    sched = FlowMatchEulerScheduler()
    rep = RepellencyConfig(method="kernel_fast", sigma=1.0, scale=0.03,
                           use_beta_gate=False, normalize_x=True)
    window = RepellencyWindow(1000.0, 780.0)
    ts, sigmas = sched.timesteps_and_sigmas(PAR_SD3_STEPS)
    in_window = sum(bool(window.mask(i, float(t))) for i, t in enumerate(ts))
    counts = {}

    def run(name, fn=tf, bank=refs, rep_bank=None):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            lat, applied = sample_sd3(
                fn, sched, ctx, pooled, lat0, lambda i, salt: noise[i],
                PAR_SD3_STEPS, guidance_scale=2.5, repellency=rep,
                refs=bank, window=window, rep_bank=rep_bank)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        print(f"{name}: {PAR_SD3_STEPS} steps in "
              f"{time.perf_counter() - t0:.3f} s, applied "
              f"{applied.any(1).tolist()}, launches "
              f"B1 {counts[name]['attention']} B2 {counts[name]['rbf']} "
              f"adaln {counts[name]['adaln']}")
        return lat

    def check_adaln(name, sites_a_step):
        want = sites_a_step * (PAR_SD3_STEPS if name != "sd3-tp" else 1)
        if counts[name]["adaln"] != want:
            fail(f"{name}: adaln launched {counts[name]['adaln']} times, "
                 f"expected {want}")

    with torch.no_grad():          # warm-up: cuBLAS, B1's first load
        sample_sd3(tf, sched, ctx, pooled, lat0, lambda i, salt: noise[i],
                   PAR_SD3_STEPS, guidance_scale=2.5, repellency=rep,
                   refs=refs, window=window, steps=(0,))
    want = run("sd3-unsharded")
    steps_b1 = PAR_SD3_LAYERS * PAR_SD3_STEPS
    if counts["sd3-unsharded"]["attention"] != steps_b1:
        fail("sd3-unsharded: B1 did not run once per block and step")
    sites = 6 * PAR_SD3_LAYERS - 1      # adaln a forward
    check_adaln("sd3-unsharded", sites)
    tf.sp_mesh = make_mesh(devices=devices[:2], axis="seq")
    try:
        got = run("sd3-sp")
    finally:
        tf.sp_mesh = None
    if counts["sd3-sp"]["attention"] != 0:
        fail("sd3-sp: the split attention must take the plain form, as "
             "JAX's does")
    # every block's sites on each of the 2 slots' slices, norm_out once
    check_adaln("sd3-sp", 2 * (sites - 1) + 1)
    _check_rel("sd3-sp vs unsharded", got, want)
    pp_mesh = make_mesh(devices=devices[:4], axis="pipe")
    tf.pp_mesh = pp_mesh
    stacked = shard_stacked_pp(
        stack_block_params(tf, PAR_SD3_LAYERS, 4), pp_mesh)
    try:
        got = run("sd3-pp", lambda *a: tf(*a, pp_params=stacked))
    finally:
        tf.pp_mesh = None
    # 5 blocks and 3 zero blocks a microbatch, the last block on the batch
    want_b1 = (8 * 2 + 1) * PAR_SD3_STEPS
    if counts["sd3-pp"]["attention"] != want_b1:
        fail(f"sd3-pp: B1 launched {counts['sd3-pp']['attention']} times, "
             f"expected {want_b1}")
    check_adaln("sd3-pp", 6 * 8 * 2 + 4 + 1)
    _check_rel("sd3-pp vs unsharded", got, want)
    # the random bank's weights underflow to 0 (the score is 0 sharded or
    # not): 4 of its 16 rows become the run's own channel-normalized x0 at
    # step 0 (in the window), whose weights are ~1 there
    if not window.mask(0, float(ts[0])):
        fail("sd3-bank-shard: step 0 is not in the repellency window")
    with torch.no_grad():
        t_in = torch.full((2,), float(ts[0]), device=dev)
        v = tf(torch.cat([lat0, lat0]), t_in, ctx[:, 0], pooled[:, 0])
        v = v[:1] + 2.5 * (v[1:] - v[:1])
        x0 = lat0 - float(sigmas[0]) * v
        own = (x0 / x0.norm(dim=1, keepdim=True)).float()
    own_bank = torch.cat([own.repeat(4, 1, 1, 1), refs[4:]])
    want_own = run("sd3-bank-own", bank=own_bank)
    moved = _rel(want_own, want)
    print(f"sd3-bank-own: a bank holding the run's own x0 moves the latents "
          f"by max|d|/max|random bank|={moved:.3e}")
    if not moved > 0:
        fail("sd3-bank-own: the score did not move the latents")
    bank_mesh = make_mesh(devices=devices[:4])
    got = run("sd3-bank-shard", bank=shard_bank(own_bank, bank_mesh),
              rep_bank=ShardedBank(bank_mesh))
    if counts["sd3-bank-shard"]["rbf"] != 4 * in_window:
        fail("sd3-bank-shard: B2 did not run once per shard and step")
    check_adaln("sd3-bank-shard", sites)
    _check_rel("sd3-bank-shard vs replicated", got, want_own)
    # one forward over 2 model slots
    x = torch.cat([lat0, lat0])
    t_in = torch.full((2,), float(ts[0]), device=dev)
    args = (x, t_in, ctx[:, 0], pooled[:, 0])
    with torch.no_grad():
        want_v = tf(*args)
        shard_params_tp(tf, make_mesh(devices=devices[:2], axis="model"))
        try:
            ops.reset_launch_counts()
            got_v = tf(*args)
            torch.cuda.synchronize()
            counts["sd3-tp"] = ops.launch_counts()
        finally:
            clear_tp(tf)
    print(f"sd3-tp: one forward over model {slots_text(devices[:2])}, B1 "
          f"{counts['sd3-tp']['attention']} launches at [2,4429,12,64]")
    if counts["sd3-tp"]["attention"] != 2 * PAR_SD3_LAYERS:
        fail("sd3-tp: B1 did not run once per block and slot")
    check_adaln("sd3-tp", sites)
    _check_rel("sd3-tp vs unsharded", got_v, want_v)
    del tf
    torch.cuda.empty_cache()
    return counts


def phase_parallel_serve(mesh_pipe, kw, subs) -> dict:
    """serve-mesh: the dynamic batcher's two-phase hook on sd14-mesh's
    2-slot pipeline, phase 4's four requests as one batch, each PNG equal
    to its slot's generate_batch; then ``runners.serve --mesh 2`` must
    raise on this machine's one GPU before it writes anything."""
    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.runners import serve
    from safe_denoiser_tpu_torch.serving import DynamicBatcher, GenRequest
    import numpy as np

    opts = {k: v for k, v in kw.items() if k != "guidance_scales"}

    def dispatch(reqs):
        return mesh_pipe.dispatch_batch(
            [r.prompt for r in reqs], [r.seed for r in reqs],
            [r.guidance_scale for r in reqs], num_inference_steps=50,
            **opts)

    batcher = DynamicBatcher(lambda reqs: dispatch(reqs).fetch(), 4,
                             max_delay_s=SERVE_DELAY_MS / 1000.0,
                             dispatch_batch=dispatch)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        futs = [batcher.submit(GenRequest(p, seed=i, guidance_scale=7.5))
                for i, p in enumerate(PROMPTS)]
        rows = [f.result(timeout=600) for f in futs]
    finally:
        batcher.close()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    for i, row in enumerate(rows):
        if not np.array_equal(row, subs[i // 2][1][i % 2]):
            fail(f"serve-mesh: request {i}'s image differs from "
                 "generate_batch on its slot's sub-batch")
    print(f"serve-mesh: 4 requests, one batch over 2 slots, wall_s="
          f"{wall:.3f}; each image equal to its slot's generate_batch")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "serve")
        try:
            serve.main(["--model_dir", tmp, "--mesh", "2", "--save-dir",
                        out])
        except RuntimeError as e:
            print(f"serve --mesh 2 on one GPU raised: {e}")
        else:
            fail("serve --mesh 2 did not raise on a machine with one GPU")
        if os.path.exists(out):
            fail("serve --mesh 2 wrote its --save-dir before raising")
    return counts


def phase_parallel_dryrun() -> None:
    """The sixteen dryrun paths over 8 cuda:0 slots."""
    from safe_denoiser_tpu_torch.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    dryrun_multichip(devices=["cuda:0"] * 8)
    print(f"dryrun_multichip over 8 cuda:0 slots: "
          f"{time.perf_counter() - t0:.1f} s")


def phase_parallel(pipe, kw, gate) -> dict:
    """Phase 11: the parallel layer on cuda:0 slots (sd14-mesh, the sharded
    bank, unet-tp, sd3-parallel, serve-mesh, the dryrun's paths). Returns
    the launch counts of its runs."""
    t0 = time.perf_counter()
    counts, mesh_pipe, subs = phase_parallel_sd14(pipe, kw, gate)
    counts["serve-mesh"] = phase_parallel_serve(mesh_pipe, kw, subs)
    del mesh_pipe
    pipe._graphs.release()
    counts.update(phase_parallel_sd3())
    phase_parallel_dryrun()
    print(f"phase 11 (parallel): {time.perf_counter() - t0:.1f} s")
    return counts


# phase 12, the tail: the classify runner's seeds, the data loop's prompts
# (their images filed at threshold 0, every one), the toy detector's image
TAIL_SEEDS = 4
TAIL_PROMPT = PROMPTS[0]
LOOP_SEED = 200
DETECTOR_HW = (192, 256)


# the packages the port's tail must run without: phase 12 runs with each
# made unimportable
NO_PACKAGES = ("PIL", "cv2", "pandas", "yaml")


@contextlib.contextmanager
def without_packages(names):
    """``import name`` raises ImportError inside the block, for each of
    ``names`` and its submodules; ``sys.modules`` restored on exit."""
    saved = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] in names}
    for k in saved:
        del sys.modules[k]
    for name in names:
        sys.modules[name] = None
    try:
        yield
    finally:
        for name in names:
            sys.modules.pop(name, None)
        sys.modules.update(saved)


def toy_detector_onnx(seed: int = 3) -> tuple:
    """A detector graph with the NudeNet detector's outputs, as an ONNX
    ModelProto and its weights: NHWC caffe-mode input -> Transpose ->
    GlobalAveragePool -> the [1, 3] channel means -> sigmoid scores [1, 3],
    boxes [1, 3, 4] and int32 labels [1, 3] in {0, 1, 2}, listed scores
    first and labels last (the detector sniffs them by dtype and shape)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    w = {"w_box": (rs.rand(3, 12) * 2 + 1).astype(np.float32),
         "w_score": (rs.rand(3, 3) * 0.1 + 0.02).astype(np.float32),
         "w_label": (rs.rand(3, 3) * 3).astype(np.float32)}
    inits = dict(w, shape2=np.array([0, -1], dtype=np.int64),
                 shape_boxes=np.array([1, 3, 4], dtype=np.int64),
                 lo=np.array(0.0, np.float32), hi=np.array(2.0, np.float32))
    node = _onnx_node
    nodes = [
        node("Transpose", ["input_1"], ["x"], _onnx_ints("perm", [0, 3, 1, 2])),
        node("GlobalAveragePool", ["x"], ["gap"]),
        node("Reshape", ["gap", "shape2"], ["feat"]),
        node("MatMul", ["feat", "w_score"], ["s0"]),
        node("Sigmoid", ["s0"], ["scores"]),
        node("MatMul", ["feat", "w_box"], ["b0"]),
        node("Reshape", ["b0", "shape_boxes"], ["boxes"]),
        node("MatMul", ["feat", "w_label"], ["l0"]),
        node("Clip", ["l0", "lo", "hi"], ["l1"]),
        node("Cast", ["l1"], ["labels"], _onnx_int("to", 6)),
    ]
    return _onnx_model("toy_detector", nodes, inits, "input_1",
                       ["scores", "boxes", "labels"]), w


def model_flops_per_image() -> dict:
    """Model FLOPs (matrix products and convolutions, ``utils.flops``) of
    one sd14-main image (CLIP-L over the batch's 2 x 4 prompts, 50 UNet
    steps at the CFG batch 8, the decode of 4, over 4) and of one sd3-main
    image (CLIP-L, bigG and T5-XXL over 2 prompts, 50 MMDiT steps at batch
    2, one decode), counted on ``meta`` at full width, and the counting's
    host seconds."""
    from safe_denoiser_tpu_torch.models import (
        CLIP_BIG_G, CLIP_VIT_L_14, SD3_MEDIUM, SD3_VAE, SD14_UNET, SD14_VAE,
        T5_XXL, AutoencoderKL, CLIPTextModel, MMDiT, T5Encoder,
        UNet2DConditionModel)
    from safe_denoiser_tpu_torch.utils.flops import model_flops

    t0 = time.perf_counter()
    e = torch.empty
    with torch.device("meta"):
        unet, vae = UNet2DConditionModel(SD14_UNET), AutoencoderKL(SD14_VAE)
        clip_l = CLIPTextModel(CLIP_VIT_L_14)
        clip_lp = CLIPTextModel(CLIP_VIT_L_14, with_projection=True)
        clip_g = CLIPTextModel(CLIP_BIG_G, with_projection=True)
        t5, mmdit, vae3 = T5Encoder(T5_XXL), MMDiT(SD3_MEDIUM), \
            AutoencoderKL(SD3_VAE)
    b, steps = 4, 50
    ids = torch.zeros(2 * b, 77, dtype=torch.long)
    sd14 = {"encode": model_flops(clip_l, ids),
            "step": model_flops(unet, e(2 * b, 4, 64, 64), 500,
                                e(2 * b, 77, CLIP_VIT_L_14.hidden_size)),
            "decode": model_flops(vae.decode, e(b, 4, 64, 64))}
    sd14["image"] = (sd14["encode"] + steps * sd14["step"]
                     + sd14["decode"]) / b
    ids2 = torch.zeros(2, 77, dtype=torch.long)
    ctx = 77 + 256
    sd3 = {"encode": (model_flops(clip_lp, ids2) + model_flops(clip_g, ids2)
                      + model_flops(t5, torch.zeros(2, 256,
                                                    dtype=torch.long))),
           "step": model_flops(mmdit, e(2, 16, 128, 128), e(2),
                               e(2, ctx, SD3_MEDIUM.joint_attention_dim),
                               e(2, SD3_MEDIUM.pooled_projection_dim)),
           "decode": model_flops(vae3.decode, e(1, 16, 128, 128))}
    sd3["image"] = sd3["encode"] + steps * sd3["step"] + sd3["decode"]
    return {"sd14": sd14, "sd3": sd3, "host_s": time.perf_counter() - t0}


def phase_tail(pipe, kw, assets: dict, card: str) -> dict:
    """12: the JAX package's last modules through the port, on phase 4's
    pipeline and phase 6's checkpoint, gate and output, with PIL, cv2,
    pandas and yaml made unimportable (``without_packages``). Returns the
    launch counts of its runs.

    - profiling: ``utils.profiling.trace`` around one graphed sd14-main
      batch inside an ``annotate`` region: the trace names B1's and B4's
      kernels and the region, and holds the recorder's
      ``sdt.graph.replay_loop`` span of that batch inside the region;
      another batch timed on the host clock to its fetch;
    - flops: the model FLOPs of an sd14-main and an sd3-main image counted
      on ``meta`` at full width, and the MFU of this run's graphed
      sd14-main loop and batch against 989e12;
    - classify: ``runners.classify`` (TAIL_SEEDS seeds x 50 steps at 512^2,
      the one-conv gate as the path-based Classifier); each PNG equal to
      phase 4's pipeline's ``dispatch(seed).fetch()`` (the same weights),
      launches as derived; the per-seed time of those dispatches;
    - data loop: ``tools.data_prep.generate_negative_bank`` on phase 4's
      pipeline with the NudeNet gate over PROMPTS, then the runners' bank
      loader (``runners.common.build_repellency``) encodes the filed PNGs
      into a .pt bank through B4, and two 5-step kernel_fast batches
      against that .pt (scale 0.33 and 0) with the beta gate open (sigma
      from the first step's distances to the bank): B2 launched, the
      latents moved;
    - logs: ``runners.nudity`` on phase 6's cases as --num_shards 2 (shard
      0, shard 1): each shard's PNGs equal phase 6's, ``merge_detect_dicts``
      of the two equal to phase 6's detect_dict.json (sizes, ratios and
      the unsafe flags exactly; the mean predictions, re-summed, to 1e-12),
      and ``parse_log`` on phase 6's logs.txt, one record per case;
    - tokenizer: ``text.native``'s ids equal the Python path's on the
      runners' prompts; the path phase 4's pipeline takes;
    - detector: ``evals.nudenet_detector.Detector`` on a toy detector
      graph: ``detect`` against the numpy reference and ``censor``'s
      blanked boxes."""
    import importlib.util

    t_phase = time.perf_counter()
    tmp, ckpt, onnx = assets["tmp"], assets["ckpt"], assets["onnx"]
    runs = {}
    installed = [m for m in NO_PACKAGES if importlib.util.find_spec(m)]
    with without_packages(NO_PACKAGES):
        _tail_body(pipe, kw, tmp, ckpt, onnx, card, runs)
    print(f"tail: phase 12 took {time.perf_counter() - t_phase:.1f} s, "
          f"with {list(NO_PACKAGES)} made unimportable (installed here: "
          f"{installed})")
    return runs


def _tail_body(pipe, kw, tmp, ckpt, onnx, card, runs) -> None:
    """Phase 12's checks, in the order of ``phase_tail``'s docstring."""
    import re
    from types import SimpleNamespace

    import numpy as np

    from safe_denoiser_tpu_torch import ops
    from safe_denoiser_tpu_torch.data.images import read_png, write_png
    from safe_denoiser_tpu_torch.evals.nudenet import NudeClassifier
    from safe_denoiser_tpu_torch.evals.nudenet_detector import (
        Detector, preprocess_image)
    from safe_denoiser_tpu_torch.runners.classify import main as run_classify
    from safe_denoiser_tpu_torch.runners.common import build_repellency
    from safe_denoiser_tpu_torch.runners.nudity import main as run_nudity
    from safe_denoiser_tpu_torch.text.clip_tokenizer import (basic_clean,
                                                             whitespace_clean)
    from safe_denoiser_tpu_torch.text.native import NativeBPE
    from safe_denoiser_tpu_torch.tools.data_prep import \
        generate_negative_bank
    from safe_denoiser_tpu_torch.tools.logs import (merge_detect_dicts,
                                                    parse_log)
    from safe_denoiser_tpu_torch.utils import profiling
    from safe_denoiser_tpu_torch.utils.flops import H100_PEAK_BF16, mfu


    # profiling and MFU
    flops = model_flops_per_image()
    seeds = [0, 1, 2, 3]
    # phase 4's graphs of this batch are still captured: a replay
    pipe.dispatch_batch(PROMPTS, seeds=seeds, num_inference_steps=50,
                        **kw).fetch()
    trace_dir = os.path.join(tmp, "trace")
    ops.reset_launch_counts()
    with profiling.trace(trace_dir):
        with profiling.annotate("sd14-main batch"):
            pipe.dispatch_batch(PROMPTS, seeds=seeds, num_inference_steps=50,
                                **kw).fetch()
    runs["traced"] = ops.launch_counts()
    text = open(os.path.join(trace_dir, profiling.TRACE_FILE)).read()
    events = json.loads(text)["traceEvents"]
    region = [e for e in events if e.get("name") == "sd14-main batch"]
    replays = [e for e in events if e.get("name") == "sdt.graph.replay_loop"
               and region and region[0]["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= region[0]["ts"] + region[0]["dur"]]
    names = {"B1 attn_kernel": "attn_kernel" in text,
             "B4 conv_kernel<false>": ("conv_kernel<false>" in text
                                       or "conv_kernelILb0E" in text),
             "annotate": bool(region),
             "sdt.graph.replay_loop in the region": len(replays) == 1}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pending = pipe.dispatch_batch(PROMPTS, seeds=seeds,
                                  num_inference_steps=50, **kw)
    pending.fetch()
    batch_s = time.perf_counter() - t0
    runs["timed"] = ops.launch_counts()
    event_ms = sum(pending.stage_ms.values())
    timer_ms = batch_s * 1e3
    loop_ms = pending.stage_ms["loop"]
    ips = 4 / batch_s
    mfu_loop = mfu(4 / (loop_ms / 1e3), 50 * flops["sd14"]["step"] / 4)
    print(f"tail profiling: trace of one graphed sd14-main batch, "
          f"{os.path.getsize(os.path.join(trace_dir, profiling.TRACE_FILE))} "
          f"bytes, names {json.dumps(names)}; a batch to its fetch "
          f"{timer_ms:.2f} ms, its CUDA events {event_ms:.2f} ms "
          f"(stages {json.dumps({k: round(v, 2) for k, v in pending.stage_ms.items()})})")
    f14, f3 = flops["sd14"], flops["sd3"]
    print(f"tail flops ({card}): counted on meta at full width in "
          f"{flops['host_s']:.1f} s; sd14-main image {f14['image']:.6e} "
          f"(CLIP 2x4 prompts {f14['encode']:.6e}, UNet step at batch 8 "
          f"{f14['step']:.6e}, decode of 4 {f14['decode']:.6e}); sd3-main "
          f"image {f3['image']:.6e} (encoders {f3['encode']:.6e}, MMDiT step "
          f"at batch 2 {f3['step']:.6e}, decode {f3['decode']:.6e})")
    print(f"tail mfu ({card}): peak {H100_PEAK_BF16:.4g}; sd14-main graphed "
          f"loop {loop_ms:.2f} ms -> mfu_loop={mfu_loop:.4f}; batch "
          f"{timer_ms:.2f} ms, images_per_s={ips:.4f} -> "
          f"mfu_e2e={mfu(ips, f14['image']):.4f}")
    if not all(names.values()):
        fail(f"tail profiling: the trace lacks {names}")
    check_launches(runs["traced"], EXPECTED_LAUNCHES, "tail traced batch")
    check_launches(runs["timed"], EXPECTED_LAUNCHES, "tail timed batch")

    # classify
    img_dir = os.path.join(tmp, "classify")
    wall, counts, log = _run_quiet(run_classify, [
        "--model_dir", ckpt, "--nudenet-path", onnx, "--img_dir", img_dir,
        "--prompt", TAIL_PROMPT, "--num_seeds", str(TAIL_SEEDS),
        "--num_inference_steps", "50", "--device", "cuda"])
    runs["classify"] = counts
    want = runner_launches(pipe, TAIL_SEEDS, 0)
    nude = re.findall(r"Nude cnt:\s+(\d+)", log)
    pngs = sorted(os.listdir(img_dir))
    seed_ms, same = [], []
    for seed in range(TAIL_SEEDS):
        t0 = time.perf_counter()
        img = pipe.dispatch(TAIL_PROMPT, seed=seed, num_inference_steps=50,
                            guidance_scale=7.5).fetch()[0]
        seed_ms.append((time.perf_counter() - t0) * 1e3)
        same.append(bool(np.array_equal(
            img, read_png(os.path.join(img_dir, f"{seed}.png")))))
    print(f"tail classify ({card}): runners.classify {TAIL_SEEDS} seeds x "
          f"50 steps at 512^2: wall_s={wall:.3f} "
          f"wall_s_per_seed={wall / TAIL_SEEDS:.3f} (checkpoint load, graph "
          f"capture and classification included) nude_cnt={nude} "
          f"PNGs equal to dispatch(seed)={same}; dispatch to fetch per seed "
          f"ms={[round(v, 2) for v in seed_ms]} (the first captures)")
    print(f"tail classify launches: {json.dumps(counts)} expected "
          f"{json.dumps(want)}")
    if pngs != [f"{s}.png" for s in range(TAIL_SEEDS)] or not all(same) \
            or len(nude) != 1 or "Nude rate:" not in log:
        print(log[-2000:])
        fail("tail classify: output or PNGs differ from dispatch(seed)")
    check_launches(counts, want, "tail classify")

    # the data loop
    gate = NudeClassifier(onnx)
    preds = []

    def eval_func(imgs, threshold):
        is_unsafe, pred = gate(imgs, threshold=threshold)
        preds.append(pred)
        return is_unsafe, pred

    lines = _Lines()
    loop_root = os.path.join(tmp, "loop")
    loop_dir = os.path.join(loop_root, "i2p_sexual")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    n_filed = generate_negative_bank(pipe, PROMPTS, eval_func, loop_dir,
                                     threshold=0.0, num_inference_steps=50,
                                     seed=LOOP_SEED, logger=lines)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    runs["data_loop"] = ops.launch_counts()
    filed = sorted(os.listdir(loop_dir))
    print(f"tail data loop ({card}): generate_negative_bank over "
          f"{len(PROMPTS)} prompts x 50 steps at 512^2, threshold 0: "
          f"filed {n_filed} {filed} preds={[round(p, 4) for p in preds]} "
          f"wall_s={loop_s:.3f} per_prompt_s={loop_s / len(PROMPTS):.3f}")
    check_launches(runs["data_loop"], runner_launches(pipe, len(PROMPTS), 0),
                   "tail data loop")
    if n_filed != len(PROMPTS) or filed != [f"{i:06d}.png" for i in
                                            range(len(PROMPTS))] \
            or len(lines.lines) != len(PROMPTS):
        fail("tail data loop: the bank's files or log lines")
    bank_pt = os.path.join(tmp, "loop_bank.pt")
    task = os.path.join(tmp, "loop_task.yaml")
    with open(task, "w") as f:
        f.write(f"""repellency:
  method: kernel_fast
  n_embed: {len(PROMPTS)}
  params:
    sigma: 3.15
    scale: 0.33
    beta_threshold: 1.0e-12
    proj_ref_path: {bank_pt}
data:
  name: nudity
  root: {loop_root}
  class_info: i2p_sexual
  size: 512
""")
    ops.reset_launch_counts()
    build_repellency(SimpleNamespace(task_config=task, image_length=512,
                                     num_inference_steps=GATE_STEPS),
                     pipe, _Lines())
    torch.cuda.synchronize()
    enc_counts = ops.launch_counts()
    enc_want = dict.fromkeys(EXPECTED_LAUNCHES, 0)
    enc_want.update(vae_kernel_plan(pipe.vae.config, len(PROMPTS), 512, 512,
                                    "encoder")[0])
    check_launches(enc_counts, enc_want, "tail bank encode")
    bank = torch.load(bank_pt, weights_only=True).to(pipe.device)
    t, x0 = first_step_x0(pipe, GATE_STEPS, [0, 1, 2, 3])
    d2 = torch.cdist(x0.flatten(1), bank.flatten(1)) ** 2
    sigma = math.sqrt(float(d2.min(1).values.max()) / 40.0)
    out = gate_runs(pipe, bank_pt, sigma=sigma, beta_threshold=1e-12)
    (lat_a, applied, rbf_n), (lat_b, _, _) = out[0.33], out[0.0]
    gap = (lat_a - lat_b).abs().max().item()
    runs["loop_bank"] = enc_counts
    print(f"tail data loop bank: {tuple(bank.shape)} from the filed PNGs "
          f"through the bank loader (B4 {enc_counts['conv3x3']}); "
          f"{GATE_STEPS}-step kernel_fast batches at sigma={sigma:.4f} "
          f"(nearest weight >= e^-20 at t={t}), beta threshold 1e-12: "
          f"applied per step {applied.any(1).tolist()} rbf launches {rbf_n} "
          f"max|latents(0.33) - latents(0)|={gap:.4e}")
    if not (bool(applied[0].all()) and rbf_n == 1 and gap > 0
            and bool(torch.isfinite(lat_a).all())):
        fail("tail data loop: the loop's bank did not reach the latents")
    del out, lat_a, lat_b, bank

    # logs: phase 6's run in two shards
    base = ["--data", os.path.join(tmp, "prompts.csv"), "--erase_id",
            "std_rep", "--model_dir", ckpt, "--task_config",
            os.path.join(tmp, "task.yaml"), "--nudenet-path", onnx,
            "--num_inference_steps", "50", "--image_length", "512",
            "--device", "cuda", "--num_shards", "2"]
    full = os.path.join(tmp, "out")
    shards, shard_walls = [], []
    for k in range(2):
        out_k = os.path.join(tmp, f"out_shard{k}")
        wall, counts, _ = _run_quiet(run_nudity, base + [
            "--shard_id", str(k), "--save-dir", out_k])
        n_k = len(range(k, RUNNER_CASES, 2))
        check_launches(counts, runner_launches(
            pipe, n_k, 10, RUNNER_BANK // RUNNER_N_EMBED, RUNNER_N_EMBED),
            f"tail shard {k}")
        runs[f"shard{k}"] = counts
        shard_walls.append(wall)
        for name in os.listdir(os.path.join(out_k, "all")):
            a = read_png(os.path.join(out_k, "all", name))
            if not np.array_equal(a, read_png(os.path.join(full, "all",
                                                            name))):
                fail(f"tail shard {k}: {name} differs from phase 6's")
        shards.append(json.load(open(os.path.join(out_k,
                                                  "detect_dict.json"))))
    merged = merge_detect_dicts(shards)
    want = json.load(open(os.path.join(full, "detect_dict.json")))
    pred_d = max(abs(merged["toxic_pred_ratio"][c] - v) / max(abs(v), 1e-30)
                 for c, v in want["toxic_pred_ratio"].items())
    records = parse_log(open(os.path.join(full, "logs.txt")).read())
    print(f"tail logs: 2 shards of phase 6's {RUNNER_CASES} cases, wall_s="
          f"{[round(w, 3) for w in shard_walls]}; merged sizes "
          f"{merged['toxic_size']} ratios {merged['toxic_ratio']} (phase 6: "
          f"{want['toxic_size']} {want['toxic_ratio']}), mean predictions' "
          f"rel. diff {pred_d:.3e}; parse_log: {len(records)} records, "
          f"cases {[r.case_number for r in records]} seeds "
          f"{[r.seed for r in records]} unsafe {[r.unsafe for r in records]} "
          f"wall_s {[r.wall_clock_s for r in records]} (the overlapped "
          f"runner logs a case's result lines after the next case begins)")
    if not (merged["toxic_size"] == want["toxic_size"]
            and merged["toxic_ratio"] == want["toxic_ratio"]
            and sorted(merged["unsafe"]) == sorted(want["unsafe"])
            and set(merged["toxic_pred_ratio"]) == set(
                want["toxic_pred_ratio"]) and pred_d <= 1e-12):
        fail("tail logs: the merged shards differ from the unsharded run")
    if [(r.case_number, r.seed, r.prompt) for r in records] != [
            (str(i), 100 + i, p) for i, p in
            enumerate(PROMPTS[:RUNNER_CASES])]:
        fail("tail logs: parse_log does not read one record per case")

    # tokenizer
    tok = pipe.tokenizer
    prompts = [*PROMPTS, TAIL_PROMPT, "naïve café, the DOG's 123 runs!!"]
    native = NativeBPE(tok.vocab, sorted(tok.bpe_ranks, key=tok.bpe_ranks.get))
    ids_n = [native.encode(whitespace_clean(basic_clean(p)).lower())
             for p in prompts]
    ids_p = [tok.encode_python(p) for p in prompts]
    print(f"tail tokenizer: native ids equal the Python path's on "
          f"{len(prompts)} prompts: {ids_n == ids_p}; the pipelines' "
          f"tokenizer path: {tok.engine}")
    if ids_n != ids_p or tok.engine != "native":
        fail("tail tokenizer: the native engine's ids differ or it is not "
             "in use")

    # detector
    model, w = toy_detector_onnx()
    det_path = os.path.join(tmp, "detector.onnx")
    with open(det_path, "wb") as f:
        f.write(model)
    rs = np.random.RandomState(5)
    img = rs.randint(0, 256, (*DETECTOR_HW, 3), dtype=np.uint8)
    img_path = os.path.join(tmp, "detect.png")
    write_png(img, img_path)
    det = Detector(det_path)
    got = det.detect(img_path, min_prob=0.0)
    image, scale = preprocess_image(img_path)
    feat = image.transpose(2, 0, 1).reshape(3, -1).mean(axis=1)[None]
    scores = 1 / (1 + np.exp(-(feat @ w["w_score"])))
    boxes = (feat @ w["w_box"]).reshape(1, 3, 4) / scale
    labels = np.clip(feat @ w["w_label"], 0.0, 2.0).astype(np.int32)
    ref = [{"box": [int(c) for c in b.astype(int)], "score": float(s),
            "label": det.classes[int(lab)]}
           for b, s, lab in zip(boxes[0], scores[0], labels[0])]
    censored_path = os.path.join(tmp, "censored.png")
    det.censor(img_path, out_path=censored_path)
    cens = read_png(censored_path)
    blank = np.zeros(DETECTOR_HW, bool)
    for r in det.detect(img_path):       # cv2.rectangle's filled corners
        x1, y1, x2, y2 = r["box"]
        blank[max(min(y1, y2), 0):max(max(y1, y2) + 1, 0),
              max(min(x1, x2), 0):max(max(x1, x2) + 1, 0)] = True
    print(f"tail detector: {len(got)} boxes {[g['box'] for g in got]} scores "
          f"{[round(g['score'], 5) for g in got]}; censored {int(blank.sum())} "
          f"pixels")
    if len(got) != 3 or any(
            g["box"] != r["box"] or g["label"] != r["label"]
            or abs(g["score"] - r["score"]) > 1e-5 for g, r in zip(got, ref)):
        fail(f"tail detector: {got} against {ref}")
    if not blank.any() or (cens[blank] != 0).any() or \
            not np.array_equal(cens[~blank], img[~blank]):
        fail("tail detector: censor did not blank exactly the boxes")


def phase_profile(pipe, kw, steps: int = 10) -> None:
    """One batch of the main path at ``steps`` DDPM steps, profiled twice on
    the same buffers: replayed from its CUDA graphs (captured first), then
    the eager loop body and decode -- the device's idle share of each."""
    from safe_denoiser_tpu_torch.pipeline import graph

    program, bufs = pipe._prepare_batch(PROMPTS, [0, 1, 2, 3],
                                        num_inference_steps=steps, **kw)
    pipe._launch(program, bufs).fetch()
    profile_call(lambda: pipe._launch(program, bufs),
                 f"graphed, {steps} steps, batch 4")
    profile_call(lambda: graph._run_eager(program, bufs),
                 f"eager, {steps} steps, batch 4")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile a 10-step batch; "
                         "a 10-step SPELL and CoPro case; after each SD3 "
                         "run, a 5-step image")
    ap.add_argument("--parent", metavar="DIR",
                    help="an earlier checkout whose B1, B9, B10, B4, B3, B8, "
                         "B7, B2 and B6 phase 3b times against this one's")
    args = ap.parse_args()
    try:
        import safe_denoiser_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    card = phase_env()
    phase_build()
    results = phase_kernels()
    results.update(phase_backward_kernels())
    results.update(phase_adaln())
    if args.parent:
        phase_parent(args.parent)
    counts, pipe, kw = phase_main_path()
    gate = phase_gate_open(pipe)
    parallel_counts = phase_parallel(pipe, kw, gate)
    del gate
    with tempfile.TemporaryDirectory() as tmp:
        assets = write_runner_assets(pipe, tmp)
        phase_runner(pipe, assets)
        tail_counts = phase_tail(pipe, kw, assets, card)
        runner_counts = phase_artist_sparse(pipe, assets, args.profile)
        runner_counts.update(phase_copro(pipe, assets, args.profile))
        coco_counts, coco = phase_coco(pipe, assets)
        runner_counts.update(coco_counts)
        phase_offline_eval(assets, coco)
        runner_counts.update(phase_serve(pipe, assets))
        runner_counts["training"] = phase_training(assets)
    ddim_counts = phase_ddim(pipe, kw)
    erasure_counts = phase_erasure(pipe, kw)
    if args.profile:
        phase_profile(pipe, kw)
    del pipe, kw
    torch.cuda.empty_cache()
    sd3_counts = phase_sd3(args.profile)
    sd3_counts.update(phase_sd3_runner())
    # launches over the main paths: sd14-main, the artist, SPELL, CoPro and
    # three COCO runner runs (6e, 6f, 6g), phase 12's classify, data-loop,
    # bank-encode, shard, traced and timed runs, the SD-v1 server's requests (9),
    # the four DDIM runs (6b, 6c), the three erasure runs (6d), the three
    # SD3 runs, the SD3 decode under SDT_UP_FORM=interleave, the SD3 COCO
    # run (8b), the SD3 server's requests (9), and phase 11's sd14-mesh,
    # sharded-bank, unet-tp, serve-mesh and SD3 runs
    runs = [counts, *runner_counts.values(), *tail_counts.values(),
            *ddim_counts.values(),
            *erasure_counts.values(), *sd3_counts.values(),
            *parallel_counts.values()]
    total = {name: sum(c.get(name, 0) for c in runs)
             for name in (*counts, *BWD_KERNELS)}
    print(card)
    print(kernels_line(results, total))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
