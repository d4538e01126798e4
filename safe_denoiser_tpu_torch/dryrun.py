"""The parallel layer's sixteen paths at tiny sizes: the port's counterpart
of ``__graft_entry__.py::dryrun_multichip``.

    python -m safe_denoiser_tpu_torch.dryrun --cpu 8    # 8 CPU slots
    python -m safe_denoiser_tpu_torch.dryrun --cuda0 8  # 8 slots on cuda:0
    python -m safe_denoiser_tpu_torch.dryrun 4          # 4 GPUs

Each path prints its ``dryrun_multichip ...: OK`` line and asserts the JAX
dry run's bounds: the data-parallel scan against the unsharded one, the
forced-open beta gate renoising every row, tensor-parallel MMDiT and UNet
forwards and scans on a (data, model) mesh, the bank-sharded score and
scans, sequence- and pipeline-parallel MMDiTs, an ESD update under (data,
model), int8 under tensor parallelism, the SD3 sequence-parallel and
bank-sharded scans, and the batcher on a data mesh. Models are f32, their
weights drawn from seeded generators; the noise is drawn once and fed to
both sides of each comparison.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .models import MMDiT, MMDiTConfig, UNet2DConditionModel, UNetConfig
from .ops.quant import (load_quantized, quantize_mmdit_params,
                        quantize_unet_params)
from .ops.repellency_kernels import rbf_negative_score_ref
from .parallel import (Mesh, ShardedBank, UNET_TP_RULES, make_mesh,
                       shard_bank, shard_batch, shard_params_tp,
                       shard_stacked_pp, sharded_negative_score,
                       slot_coords, stack_block_params)
from .parallel.mesh import module_on, on_slot, over_axis
from .pipeline.sampler import (GuidanceConfig, RepellencyWindow, sample_sd,
                               sample_sd3)
from .repellency import RepellencyConfig
from .schedulers import DDPMScheduler
from .schedulers.flow_match import FlowMatchEulerScheduler


def tiny_unet_config() -> UNetConfig:
    return UNetConfig(sample_size=8, block_out_channels=(16, 32),
                      layers_per_block=1, cross_attention_dim=16,
                      num_attention_heads=4, norm_num_groups=8)


def tiny_mmdit_config(num_layers: int = 2) -> MMDiTConfig:
    return MMDiTConfig(sample_size=8, num_layers=num_layers, num_heads=4,
                       head_dim=8, joint_attention_dim=48,
                       caption_projection_dim=32, pooled_projection_dim=40,
                       pos_embed_max_size=16)


def seeded_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Weights from a seeded generator: matrices ~ N(0, 1/fan_in), 1-D
    weights 1 + N(0, 0.05^2) (norm scales), the rest N(0, 0.05^2)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if p.dim() >= 2:
                p.copy_(r / float(np.sqrt(p[0].numel())))
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.05 * r)
            else:
                p.copy_(0.05 * r)
    return module.eval()


def _randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen)


def _two_d(devices: Sequence[torch.device], names) -> Mesh:
    n = len(devices)
    return Mesh(np.asarray(devices, dtype=object).reshape(2, n // 2), names)


def _sd_scan(unet, sched, text, latents, noise, rep, refs, window,
             rep_bank=None, guidance_scale=None):
    """One step of ``sample_sd``, with the UNet's copy on the latents'
    device; noise [2, B, C, H, W] (renoise, step)."""
    return sample_sd(module_on(unet, latents.device), sched, text, latents,
                     lambda i, salt: noise[salt - 1], 1,
                     guidance=GuidanceConfig(guidance_scale=7.5),
                     repellency=rep, refs=refs, window=window,
                     guidance_scale=guidance_scale, rep_bank=rep_bank)


def _data_parallel(mesh: Mesh, run, latents, text, noise, *extra):
    """``run`` on each data slot's rows (latents dim 0, text and noise dim
    1, ``extra`` dim 0) under that slot's coordinates and device; latents
    and the applied mask gathered back in order."""
    parts = [shard_batch(latents, mesh), shard_batch(text, mesh, batch_dim=1),
             shard_batch(noise, mesh, batch_dim=1),
             *(shard_batch(e, mesh) for e in extra)]
    outs = []
    for i in range(mesh.shape["data"]):
        with slot_coords(data=i), on_slot(parts[0][i].device):
            outs.append(run(*(p[i] for p in parts)))
    home = latents.device
    return (torch.cat([o[0].to(home) for o in outs]),
            torch.cat([o[1].to(home) for o in outs], dim=1))


@torch.no_grad()
def _paths_sd(devices, say):
    """Paths 1-3: the data-parallel scan, against the unsharded one, and
    with the beta gate forced open."""
    n = len(devices)
    home = devices[0]
    mesh = make_mesh(devices=devices)
    unet = seeded_(UNet2DConditionModel(tiny_unet_config()), 0).to(home)
    gen = torch.Generator().manual_seed(0)
    b = n
    latents = _randn(gen, b, 4, 8, 8).to(home)
    text = _randn(gen, 2, b, 7, 16).to(home)
    refs = _randn(gen, 16, 4, 8, 8).to(home)
    noise = _randn(gen, 2, b, 4, 8, 8).to(home)
    sched = DDPMScheduler()
    rep = RepellencyConfig(method="kernel_fast", sigma=3.15, scale=0.33,
                           beta_threshold=1e-3, use_beta_gate=True)
    window = RepellencyWindow(1000.0, 780.0)

    def run(lat, txt, nz, r=rep, w=window):
        return _sd_scan(unet, sched, txt, lat, nz, r, refs.to(lat.device), w)

    lat, applied = _data_parallel(mesh, run, latents, text, noise)
    assert lat.shape == (b, 4, 8, 8)
    say(f"dryrun_multichip({n}): OK, {int(applied.sum())} repellency "
        "activations")

    lat_local, _ = run(latents, text, noise)
    d_mesh = float((lat - lat_local).abs().max())
    assert d_mesh < 1e-4, f"DP-sharded scan diverges from unsharded: {d_mesh}"
    say(f"dryrun_multichip dp-vs-local({n}): OK, max|d|={d_mesh:.2e}")

    rep_act = dataclasses.replace(rep, beta_threshold=-1e9)
    window_act = RepellencyWindow(1000.0, 0.0)
    lat_a, app_a = _data_parallel(
        mesh, lambda *a: run(*a, r=rep_act, w=window_act), latents, text,
        noise)
    n_act = int(app_a.sum())
    assert n_act == b, f"forced beta gate should fire on all {b} rows, " \
        f"got {n_act}"
    moved = float((lat_a - lat).abs().max())
    assert moved > 0.0, "activating renoise branch left latents unchanged"
    say(f"dryrun_multichip activating({n}): OK, {n_act}/{b} rows renoised, "
        f"max|d|={moved:.3f}")
    return dict(mesh=mesh, unet=unet, sched=sched, rep=rep, rep_act=rep_act,
                window=window, window_act=window_act, refs=refs, text=text,
                gen=gen)


def _paths_2d(devices, ctx, say):
    """Paths 4-6 and 8-13 and 14-15: tensor, sequence and pipeline
    parallelism on (data, x) meshes, the bank-sharded scans, the ESD
    update, int8 under tensor parallelism, the SD3 scans."""
    from .training.esd import (ESDConfig, make_esd_train_step,
                               make_optimizer, module_apply_fn)
    n = len(devices)
    home = devices[0]
    tag = f"2x{n // 2}"
    gen = ctx["gen"]
    mesh2 = _two_d(devices, ("data", "model"))
    cfg3 = tiny_mmdit_config()
    mmdit = seeded_(MMDiT(cfg3), 3).to(home)
    x = _randn(gen, 2, 16, 8, 8).to(home)
    mctx = _randn(gen, 2, 12, 48).to(home)
    pooled = _randn(gen, 2, 40).to(home)
    t2 = torch.tensor([500.0, 500.0], device=home)
    unet, sched, refs = ctx["unet"], ctx["sched"], ctx["refs"]

    with torch.no_grad():
        # 4) the MMDiT tensor-parallel over (data, model)
        mmdit_tp = shard_params_tp(copy.deepcopy(mmdit), mesh2)
        v = mmdit_tp(x, t2, mctx, pooled)
        want = mmdit(x, t2, mctx, pooled)
        assert float((v - want).abs().max()) < 1e-4
        say(f"dryrun_multichip tp({tag}): OK, {tuple(v.shape)}")

        # 5) the UNet tensor-parallel
        unet_tp = shard_params_tp(copy.deepcopy(unet), mesh2,
                                  rules=UNET_TP_RULES)
        lat2 = _randn(gen, 2, 4, 8, 8).to(home)
        ctx2 = _randn(gen, 2, 7, 16).to(home)
        eps = unet_tp(lat2, 500, ctx2)
        assert float((eps - unet(lat2, 500, ctx2)).abs().max()) < 1e-4
        say(f"dryrun_multichip unet-tp({tag}): OK, {tuple(eps.shape)}")

        # 6) the sampling scan: batch over data, the UNet over model
        bt = 2
        lat_tp = _randn(gen, bt, 4, 8, 8).to(home)
        text_tp = _randn(gen, 2, bt, 7, 16).to(home)
        noise_tp = _randn(gen, 2, bt, 4, 8, 8).to(home)

        def scan_tp(model, rep, window, rep_bank=None, bank=None):
            return _data_parallel(
                mesh2, lambda lat, txt, nz: _sd_scan(
                    model, sched, txt, lat, nz, rep,
                    refs.to(lat.device) if bank is None else bank, window,
                    rep_bank), lat_tp, text_tp, noise_tp)

        lat3, _ = scan_tp(unet_tp, ctx["rep"], ctx["window"])
        say(f"dryrun_multichip tp-scan({tag}): OK, {tuple(lat3.shape)}")

        # 7) the bank-sharded score over the n-slot data mesh
        mesh = ctx["mesh"]
        x_bank = _randn(gen, 4, 256).to(home)
        refs_flat = _randn(gen, 21, 256).to(home)
        score, _ = sharded_negative_score(
            x_bank, shard_bank(refs_flat, mesh), 3.15, mesh=mesh)
        want_s, _ = rbf_negative_score_ref(x_bank, refs_flat, 3.15)
        err = float((score - want_s).abs().max())
        assert err < 1e-4, f"bank-sharded score mismatch: {err}"
        say(f"dryrun_multichip bank-shard({n}): OK, max|d|={err:.2e}")

        # 8) the scan with the bank over model, the batch over data, the
        #    beta gate forced open
        bank = ShardedBank(mesh2, axis="model", batch_axis="data")
        lat4, app4 = scan_tp(unet_tp, ctx["rep_act"], ctx["window_act"],
                             rep_bank=bank,
                             bank=shard_bank(refs, mesh2, axis="model"))
        n_bank = int(app4.sum())
        assert n_bank > 0, "bank-sharded scan: forced beta gate never fired"
        say(f"dryrun_multichip bank-scan({tag}): OK, {tuple(lat4.shape)}, "
            f"{n_bank}/{bt} rows renoised")

        # 9) sequence parallelism over (data, seq)
        mesh_sp = _two_d(devices, ("data", "seq"))
        mmdit_sp = copy.deepcopy(mmdit)
        mmdit_sp.sp_mesh = mesh_sp
        v_sp = mmdit_sp(x, t2, mctx, pooled)
        assert float((v_sp - want).abs().max()) < 1e-4
        say(f"dryrun_multichip sp({tag}): OK, {tuple(v_sp.shape)}")

        # 10) pipeline parallelism over (data, pipe): 3 layers, batch 4 =
        #     2 microbatches of 2, microbatch rows over data
        mesh_pp = _two_d(devices, ("data", "pipe"))
        cfg_pp = tiny_mmdit_config(3)
        mmdit_pp = seeded_(MMDiT(cfg_pp, pp_mesh=mesh_pp), 4).to(home)
        x4, c4, p4 = (torch.cat([a, a]) for a in (x, mctx, pooled))
        t4 = torch.full((4,), 500.0, device=home)
        stacked = shard_stacked_pp(
            stack_block_params(mmdit_pp, cfg_pp.num_layers, n // 2), mesh_pp)
        v_pp = mmdit_pp(x4, t4, c4, p4, pp_params=stacked)
        assert float((v_pp - mmdit_pp(x4, t4, c4, p4)).abs().max()) < 1e-4
        say(f"dryrun_multichip pp({tag}): OK, {tuple(v_pp.shape)}")

    # 11) one ESD update: batch over data, the UNet over model
    unet_tr = shard_params_tp(copy.deepcopy(unet), mesh2,
                              rules=UNET_TP_RULES)
    params = {k: p.detach().clone() for k, p in unet_tr.named_parameters()}
    frozen = {k: p.clone() for k, p in params.items()}
    esd_cfg = ESDConfig()
    opt = make_optimizer(esd_cfg, params)
    base = module_apply_fn(unet_tr, torch.float32)

    def dp_apply(p, xt, tt, c):
        # each data slot reads the parameters on its device (a copy that
        # autograd carries the gradients back through)
        return over_axis(mesh2, "data", lambda a, b, cc: base(
            {k: v.to(a.device) for k, v in p.items()}, a, b, cc), xt, tt, c)

    step = make_esd_train_step(dp_apply, esd_cfg)
    x_tr = _randn(gen, bt, 4, 8, 8).to(home)
    ctx_c = _randn(gen, bt, 7, 16).to(home)
    t_tr = torch.full((bt,), 500, dtype=torch.long, device=home)
    _, _, loss = step(params, frozen, opt, x_tr, t_tr, ctx_c,
                      torch.zeros_like(ctx_c))
    say(f"dryrun_multichip esd-train({tag}): OK, loss={float(loss):.4f}")

    with torch.no_grad():
        # 12) int8 W8A8 MMDiT under (data, model)
        mmdit_q = copy.deepcopy(mmdit)
        load_quantized(mmdit_q, *quantize_mmdit_params(mmdit_q.state_dict()))
        vq_want = mmdit_q(x, t2, mctx, pooled)
        vq = shard_params_tp(mmdit_q, mesh2)(x, t2, mctx, pooled)
        assert torch.isfinite(vq).all()
        say(f"dryrun_multichip int8-tp({tag}): OK, {tuple(vq.shape)}, "
            f"max|d| vs unsharded {float((vq - vq_want).abs().max()):.2e}")

        # 13) the int8 UNet in a tensor-parallel scan
        unet_q = copy.deepcopy(unet)
        load_quantized(unet_q, *quantize_unet_params(unet_q.state_dict(),
                                                     min_dim=16))
        shard_params_tp(unet_q, mesh2, rules=UNET_TP_RULES)
        lat5, _ = scan_tp(unet_q, ctx["rep"], ctx["window"])
        say(f"dryrun_multichip int8-unet-tp-scan({tag}): OK, "
            f"{tuple(lat5.shape)}")

        # 14) the SD3 scan with the image tokens over seq, the renoising
        #     repellency on at every step
        b3 = 2
        lat_sd3 = _randn(gen, b3, 16, 8, 8).to(home)
        text_sd3 = _randn(gen, 2, b3, 12, 48).to(home)
        pooled_sd3 = _randn(gen, 2, b3, 40).to(home)
        refs_sd3 = _randn(gen, 5, 16, 8, 8).to(home)
        noise3 = _randn(gen, 2, b3, 16, 8, 8).to(home)
        sched3 = FlowMatchEulerScheduler()
        rep3 = RepellencyConfig(method="kernel_fast", sigma=100.0,
                                scale=0.03, use_beta_gate=False,
                                normalize_x=True)

        def run_sd3(model, rfs, rep_bank=None):
            return sample_sd3(model, sched3, text_sd3, pooled_sd3, lat_sd3,
                              lambda i, salt: noise3[i], 2,
                              guidance_scale=2.5, repellency=rep3, refs=rfs,
                              window=RepellencyWindow(1000.0, 0.0),
                              rep_bank=rep_bank)

        lat_ref, _ = run_sd3(mmdit, refs_sd3)
        lat_sp3, app_sp3 = run_sd3(mmdit_sp, refs_sd3)
        n_sd3 = int(app_sp3.sum())
        assert n_sd3 > 0, "SD3 SP scan: repellency renoise never fired"
        d_sp3 = float((lat_sp3 - lat_ref).abs().max())
        assert d_sp3 < 2e-4, f"SD3 SP scan diverges from unsharded: {d_sp3}"
        say(f"dryrun_multichip sd3-sp-scan({tag}): OK, "
            f"{tuple(lat_sp3.shape)}, {n_sd3} renoise activations, "
            f"max|d|={d_sp3:.2e}")

        # 15) the SD3-sized bank: the sharded score at D = 16*128*128, and
        #     the SD3 scan with the bank over model, the rows over data
        d_flat = 16 * 128 * 128
        xq = _randn(gen, 2, d_flat).to(home)
        refs_big = _randn(gen, 9, d_flat).to(home)
        score3, _ = sharded_negative_score(
            xq, shard_bank(refs_big, mesh), 2.75, mesh=mesh)
        want3, _ = rbf_negative_score_ref(xq, refs_big, 2.75)
        err3 = float((score3 - want3).abs().max())
        assert err3 < 1e-4, f"SD3-dim bank-sharded score mismatch: {err3}"
        bank3 = ShardedBank(mesh2, axis="model", batch_axis="data")
        lat_b3, app_b3 = run_sd3(
            mmdit, shard_bank(refs_sd3, mesh2, axis="model"), bank3)
        assert int(app_b3.sum()) > 0, \
            "SD3 bank-sharded scan: renoise never fired"
        d_b3 = float((lat_b3 - lat_ref).abs().max())
        assert d_b3 < 2e-4, \
            f"SD3 bank-sharded scan diverges from replicated: {d_b3}"
        say(f"dryrun_multichip sd3-bank-scan({tag}): OK, kernel dim "
            f"{d_flat} max|d|={err3:.2e}, scan max|d|={d_b3:.2e}")


@torch.no_grad()
def _path_serve(devices, ctx, say):
    """Path 16: the dynamic batcher's two-phase protocol over a data mesh,
    per-request seeds and guidance scales; rows against the unsharded
    run."""
    from .serving import DynamicBatcher, GenRequest
    n = len(devices)
    home = devices[0]
    mesh, unet, sched = ctx["mesh"], ctx["unet"], ctx["sched"]
    text, refs = ctx["text"], ctx["refs"]

    def draws(seeds):
        gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
        lat = torch.stack([torch.randn((4, 8, 8), generator=g)
                           for g in gens])
        noise = torch.stack([torch.stack([torch.randn((4, 8, 8), generator=g)
                                          for g in gens]) for _ in range(2)])
        return lat.to(home), noise.to(home)

    def direct(seeds, gscale):
        lat, noise = draws(seeds)
        return _sd_scan(unet, sched, text, lat, noise, ctx["rep"], refs,
                        ctx["window"], guidance_scale=gscale)[0]

    class _MeshHandle:
        def __init__(self, lat):
            self._lat = lat

        def fetch(self):
            return list(self._lat.cpu().numpy())

    @torch.no_grad()     # the batcher's thread: grad mode is per thread
    def dispatch(reqs):
        lat, noise = draws([r.seed for r in reqs])
        gs = torch.tensor([r.guidance_scale for r in reqs], device=home)
        out, _ = _data_parallel(
            mesh, lambda la, tx, nz, g: _sd_scan(
                unet, sched, tx, la, nz, ctx["rep"], refs.to(la.device),
                ctx["window"], guidance_scale=g), lat, text, noise, gs)
        return _MeshHandle(out)

    batcher = DynamicBatcher(lambda reqs: dispatch(reqs).fetch(), n,
                             max_delay_s=0.5, dispatch_batch=dispatch)
    try:
        futs = [batcher.submit(GenRequest("p", seed=i, guidance_scale=7.5))
                for i in range(2 * n)]
        rows = [f.result(timeout=600) for f in futs]
    finally:
        batcher.close()
    want = direct(range(n), torch.full((n,), 7.5, device=home))
    d_serve = float(np.max(np.abs(np.stack(rows[:n])
                                  - want.cpu().numpy())))
    assert d_serve < 1e-5, \
        f"mesh-served batch diverges from direct run: {d_serve}"
    say(f"dryrun_multichip serve-mesh({n}): OK, {len(rows)} rows over 2 "
        f"pipelined batches, max|d|={d_serve:.2e}")


def dryrun_multichip(n_devices: Optional[int] = None,
                     devices: Optional[Sequence] = None, say=print) -> None:
    """The sixteen paths over ``devices`` (slots; repeats allowed) or the
    first ``n_devices`` GPUs. The 2-D paths need an even count >= 4."""
    if devices is None:
        devices = list(make_mesh(n_devices).devices.flat)
    devices = [torch.device(d) for d in devices]
    ctx = _paths_sd(devices, say)
    if len(devices) >= 4 and len(devices) % 2 == 0:
        _paths_2d(devices, ctx, say)
    _path_serve(devices, ctx, say)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="GPUs (default: all visible)")
    ap.add_argument("--cpu", type=int, metavar="N",
                    help="N slots on the CPU instead")
    ap.add_argument("--cuda0", type=int, metavar="N",
                    help="N slots on cuda:0 instead")
    args = ap.parse_args(argv)
    if args.cpu:
        dryrun_multichip(devices=["cpu"] * args.cpu)
    elif args.cuda0:
        dryrun_multichip(devices=["cuda:0"] * args.cuda0)
    else:
        dryrun_multichip(args.n)


if __name__ == "__main__":
    main()
