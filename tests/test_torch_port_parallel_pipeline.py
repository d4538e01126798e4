"""The parallel layer through the port's pipelines, runners and server, on
the CPU: the data mesh and the sharded bank of both pipelines against the
unsharded port and the JAX package's sharded scans (its 8 virtual CPU
devices), the two modes refusing each other with the JAX package's
messages, the server's --mesh guards, the batcher on a data-mesh
pipeline, and an ESD update under a (data, model) mesh.

Noise is the JAX package's threefry stream injected into the port's
buffers in the loop's order of draws (``tests/test_torch_port_graph.py``),
so both packages see the same numbers. Tolerances: a data-mesh slot's rows
equal, bit for bit, the unsharded pipeline's run of that slot's sub-batch
(the same program on the same rows); against the JAX scans those of
``tests/test_torch_port_graph.py`` (2e-3 / 1e-3 over the steps); the
bank-sharded loop within 1e-5 of the replicated one (f32 sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from safe_denoiser_tpu import parallel as jpar
from safe_denoiser_tpu.pipeline import sampler as j_sampler
from safe_denoiser_tpu.repellency import methods as j_methods
from safe_denoiser_tpu.schedulers import DDPMScheduler as JDDPMScheduler
from safe_denoiser_tpu.schedulers import flow_match as j_fm
from safe_denoiser_tpu_torch import parallel as tpar
from safe_denoiser_tpu_torch.pipeline.diffusion import (
    GuidanceConfig, RepellencyWindow, SafeDiffusionPipeline)
from safe_denoiser_tpu_torch.pipeline.diffusion_sd3 import \
    SafeDiffusion3Pipeline
from safe_denoiser_tpu_torch.repellency import RepellencyConfig
from safe_denoiser_tpu_torch.schedulers import DDPMScheduler
from safe_denoiser_tpu_torch.schedulers import flow_match as t_fm
from tests.test_torch_port_graph import (  # noqa: F401
    RNG, _inject, _jax_noise, jax_unet, jax_vae, sd_pipe, torch_vae, vocab)
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401
from tests.test_torch_port_sd3 import _loop_inputs, jax_mmdit, torch_mmdit

CPU = torch.device("cpu")
B, H_LAT, STEPS = 2, 8, 3
SIDE = 2 * H_LAT
REP_KW = dict(method="kernel_fast", sigma=30.0, scale=0.4, epsilon=1e-8,
              beta_threshold=1e-12, use_beta_gate=True)
WINDOW = (1000.0, 300.0)


def cpu_mesh(n, axis="data"):
    return tpar.make_mesh(devices=[CPU] * n, axis=axis)


def jmesh(n):
    return JMesh(np.asarray(jax.devices()[:n]), ("data",))


def _inputs(seed=5, m=6):
    rs = np.random.RandomState(seed)
    lat0 = rs.randn(B, 4, H_LAT, H_LAT).astype(np.float32)
    ctx = rs.randn(2, B, 5, 32).astype(np.float32)
    refs = rs.randn(m, 4, H_LAT, H_LAT).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    return lat0, ctx, refs


def _in_window(sched, rep_cfg, window):
    return [window.mask(i, int(t))
            for i, t in enumerate(sched.timesteps(STEPS))]


def _sd_pipe(base):
    return SafeDiffusionPipeline(base.unet, base.vae, base.text_encoder,
                                 base.tokenizer, DDPMScheduler(),
                                 device="cpu")


def _sd_batch(pipe, ctx, lat0, refs, rows=slice(None)):
    """The batch's program and buffers, JAX noise injected (its rows
    ``rows`` of the B-row stream)."""
    rep = RepellencyConfig(**REP_KW)
    window = RepellencyWindow(*WINDOW)
    n = lat0[rows].shape[0]
    program, bufs = pipe._batch_inputs(
        torch.from_numpy(ctx[:, rows]), None, None, [0] * n, [7.5] * n,
        STEPS, SIDE, SIDE, GuidanceConfig(), rep, torch.from_numpy(refs),
        window, None)
    bufs["latents"] = torch.from_numpy(lat0[rows].copy())
    _inject(bufs, _in_window(pipe.scheduler, rep, window),
            noise=lambda i, salt: _jax_noise(i, salt)[rows])
    return program, bufs


def _jax_sd(lat0, ctx, refs, mesh=None, rep_bank=None):
    """The JAX scan with the batch sharded over a data mesh (what its
    ``enable_data_mesh`` runs) or the bank over a ``ShardedBank``."""
    model, params = jax_unet()
    lat, txt, rfs = (jnp.asarray(lat0.transpose(0, 2, 3, 1)),
                     jnp.asarray(ctx), jnp.asarray(refs))
    if mesh is not None:
        params = jpar.replicate(params, mesh)
        lat = jpar.shard_batch(lat, mesh)
        txt = jpar.shard_batch(txt, mesh, batch_dim=1)
    if rep_bank is not None:
        rfs = jpar.shard_bank(rfs, rep_bank.mesh)
    out, applied = jax.jit(lambda a, b, c: j_sampler.sample_sd(
        lambda la, t, cc, fu: model.apply(params, la, t, cc), JDDPMScheduler(),
        b, a, RNG, STEPS, repellency=j_methods.RepellencyConfig(**REP_KW),
        refs_nchw=c, window=j_sampler.RepellencyWindow(*WINDOW),
        rep_bank=rep_bank))(lat, txt, rfs)
    return np.asarray(out).transpose(0, 3, 1, 2), np.asarray(applied)


def test_sd_data_mesh_rows_are_their_sub_batches_and_jax(sd_pipe):
    lat0, ctx, refs = _inputs()
    mesh_pipe = _sd_pipe(sd_pipe)
    mesh_pipe.enable_data_mesh(mesh=cpu_mesh(2))
    assert mesh_pipe._modules_on(CPU)[0] is sd_pipe.unet   # one device
    program, bufs = _sd_batch(mesh_pipe, ctx, lat0, refs)
    got = mesh_pipe._launch(program, bufs)
    assert sorted(got._timer.ms()) == ["decode@0", "decode@1", "loop@0",
                                       "loop@1"]
    plain = _sd_pipe(sd_pipe)
    for i in range(B):
        sub = plain._launch(*_sd_batch(plain, ctx, lat0, refs,
                                       slice(i, i + 1)))
        assert torch.equal(got.latents[i:i + 1], sub.latents)
        assert torch.equal(got.image[i:i + 1], sub.image)
        assert torch.equal(got.applied[:, i:i + 1], sub.applied)
    want, w_applied = _jax_sd(lat0, ctx, refs, mesh=jmesh(2))
    np.testing.assert_array_equal(got.applied.numpy(), w_applied)
    assert got.applied.any()
    np.testing.assert_allclose(got.latents.numpy(), want, atol=2e-3,
                               rtol=1e-3)
    with pytest.raises(ValueError, match="pick --batch_size a multiple of "
                                         "--mesh"):
        mesh_pipe._shard_batch_inputs({"latents": torch.zeros(3, 4)})


def test_sd_bank_sharded_loop_matches_jax(sd_pipe):
    """6 bank rows over 4 slots (two PAD rows)."""
    lat0, ctx, refs = _inputs()
    bank_pipe = _sd_pipe(sd_pipe)
    bank_pipe.enable_bank_sharding(cpu_mesh(4))
    program, bufs = _sd_batch(bank_pipe, ctx, lat0, refs)
    assert [bufs[f"refs.{k}"].shape[0] for k in range(4)] == [2] * 4
    assert program.graphable
    with torch.no_grad():
        got, applied = program.loop(bufs)
        plain = _sd_pipe(sd_pipe)
        p2, b2 = _sd_batch(plain, ctx, lat0, refs)
        want_rep, want_applied = p2.loop(b2)
    assert torch.equal(applied, want_applied) and applied.any()
    np.testing.assert_allclose(got.numpy(), want_rep.numpy(), atol=1e-5,
                               rtol=1e-5)
    want, w_applied = _jax_sd(lat0, ctx, refs,
                              rep_bank=jpar.ShardedBank(jmesh(4)))
    np.testing.assert_array_equal(applied.numpy(), w_applied)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)


def _sd3_parts():
    model, params = jax_mmdit()
    tf = torch_mmdit(params)
    vae = torch_vae(jax_vae()[1])
    return model, params, tf, vae


def _sd3_pipe(tf, vae):
    return SafeDiffusion3Pipeline(tf, vae, vae, vae, vae, None, None, None,
                                  t_fm.FlowMatchEulerScheduler(),
                                  device="cpu")


@pytest.mark.parametrize("mode", ["data_mesh", "bank"])
def test_sd3_parallel_modes_match_jax(mode):
    """The SD3 body (kernel_fast, channel-normalized, no gate, [1000, 500])
    under a 2-slot data mesh (rows = their sub-batches) or the bank over 4
    slots, against the JAX scan the same way sharded."""
    from safe_denoiser_tpu.pipeline.sampler import RepellencyWindow as JWin
    from safe_denoiser_tpu.pipeline.sampler import sample_sd3 as j_sample
    from safe_denoiser_tpu.repellency import RepellencyConfig as JRep
    model, params, tf, vae = _sd3_parts()
    lat0, ctx, pooled, refs = _loop_inputs()
    lat0 = np.ascontiguousarray(lat0.transpose(0, 3, 1, 2))
    rkw = dict(method="kernel_fast", sigma=10.0, scale=0.05,
               use_beta_gate=False, normalize_x=True)
    window = RepellencyWindow(1000.0, 500.0)
    rng = jax.random.PRNGKey(77)
    hw = lat0.shape[-1]

    def noise(i, salt):
        k = jax.random.fold_in(jax.random.fold_in(rng, i), salt)
        n = jax.random.normal(k, (B, hw, hw, 4), dtype=jnp.float32)
        return torch.from_numpy(np.asarray(n).transpose(0, 3, 1, 2).copy())

    def batch(pipe, rows=slice(None)):
        n = lat0[rows].shape[0]
        program, bufs = pipe._batch_inputs(
            torch.from_numpy(ctx[:, rows]), torch.from_numpy(pooled[:, rows]),
            [0] * n, [2.5] * n, STEPS, 2 * hw, 2 * hw,
            RepellencyConfig(**rkw), torch.from_numpy(refs), window)
        ts, _ = pipe.scheduler.timesteps_and_sigmas(STEPS)
        bufs["latents"] = torch.from_numpy(lat0[rows].copy())
        _inject(bufs, [window.mask(i, float(t)) for i, t in enumerate(ts)],
                step_noise=False, noise=lambda i, s: noise(i, s)[rows])
        return program, bufs

    pipe = _sd3_pipe(tf, vae)
    j_params, j_lat = params, jnp.asarray(lat0.transpose(0, 2, 3, 1))
    j_ctx, j_pooled, j_refs = map(jnp.asarray, (ctx, pooled, refs))
    j_bank = None
    if mode == "data_mesh":
        pipe.enable_data_mesh(mesh=cpu_mesh(2))
        got = pipe._launch(*batch(pipe))
        plain = _sd3_pipe(tf, vae)
        for i in range(B):
            sub = plain._launch(*batch(plain, slice(i, i + 1)))
            assert torch.equal(got.latents[i:i + 1], sub.latents)
            assert torch.equal(got.image[i:i + 1], sub.image)
        jm = jmesh(2)
        j_params = jpar.replicate(params, jm)
        j_lat = jpar.shard_batch(j_lat, jm)
        j_ctx = jpar.shard_batch(j_ctx, jm, batch_dim=1)
        j_pooled = jpar.shard_batch(j_pooled, jm, batch_dim=1)
        got_lat, got_app = got.latents, got.applied
    else:
        pipe.enable_bank_sharding(cpu_mesh(4))
        program, bufs = batch(pipe)
        assert "refs.3" in bufs
        with torch.no_grad():
            got_lat, got_app = program.loop(bufs)
            p2, b2 = batch(_sd3_pipe(tf, vae))
            rep_lat, _ = p2.loop(b2)
        np.testing.assert_allclose(got_lat.numpy(), rep_lat.numpy(),
                                   atol=1e-5, rtol=1e-5)
        j_bank = jpar.ShardedBank(jmesh(4))
        j_refs = jpar.shard_bank(j_refs, j_bank.mesh)
    want, want_app = jax.jit(lambda la, c, p, r: j_sample(
        lambda x, t, cc, pp: model.apply(j_params, x, t, cc, pp),
        j_fm.FlowMatchEulerScheduler(), c, p, la, rng, STEPS,
        guidance_scale=2.5, repellency=JRep(**rkw), refs_nchw=r,
        window=JWin(1000.0, 500.0), rep_bank=j_bank))(
            j_lat, j_ctx, j_pooled, j_refs)
    np.testing.assert_array_equal(got_app.numpy(), np.asarray(want_app))
    assert got_app.any()
    np.testing.assert_allclose(got_lat.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("family", ["sd", "sd3"])
def test_modes_refuse_each_other_with_jax_messages(family):
    from safe_denoiser_tpu.pipeline import diffusion as j_diff
    from safe_denoiser_tpu.pipeline import diffusion_sd3 as j_diff3
    cls, j_cls = ((SafeDiffusionPipeline, j_diff.SafeDiffusionPipeline)
                  if family == "sd" else
                  (SafeDiffusion3Pipeline, j_diff3.SafeDiffusion3Pipeline))
    msgs = {}
    for name, pipe, mesh, attrs in (
            ("port", cls.__new__(cls), cpu_mesh(2), ()),
            ("jax", j_cls.__new__(j_cls), jmesh(2),
             ("unet_params", "vae_params", "text_params",
              "transformer_params"))):
        for a in attrs:
            setattr(pipe, a, {})
        if name == "port":
            pipe.unet = pipe.vae = pipe.text_encoder = \
                pipe.transformer = torch.nn.Linear(1, 1)
        first = type(pipe).__new__(type(pipe))
        for a in attrs:
            setattr(first, a, {})
        if name == "port":
            first.unet = first.vae = first.text_encoder = \
                first.transformer = torch.nn.Linear(1, 1)
        pipe.enable_data_mesh(mesh=mesh)
        with pytest.raises(ValueError) as e1:
            pipe.enable_bank_sharding(mesh)
        first.enable_bank_sharding(mesh)
        with pytest.raises(ValueError) as e2:
            first.enable_data_mesh(mesh=mesh)
        msgs[name] = (str(e1.value), str(e2.value))
    assert msgs["port"] == msgs["jax"]


def test_data_mesh_copies_follow_the_pipelines_weights(sd_pipe, tmp_path):
    """A data-mesh slot on another device (``meta``: the CPU is one
    device) holds copies of the pipeline's modules, made again after
    ``load_unet_state_dict`` and ``enable_int8`` change the pipeline's, so
    no slot serves stale or un-quantized weights."""
    import copy
    meta = torch.device("meta")
    pipe = SafeDiffusionPipeline(copy.deepcopy(sd_pipe.unet), sd_pipe.vae,
                                 sd_pipe.text_encoder, sd_pipe.tokenizer,
                                 DDPMScheduler(), device="cpu")
    pipe.enable_data_mesh(mesh=tpar.Mesh([CPU, meta], ("data",)))
    assert pipe._modules_on(CPU) == (pipe.unet, pipe.vae, pipe.text_encoder)
    first = pipe._modules_on(meta)
    assert first[0] is not pipe.unet and first[0].conv_in.weight.is_meta
    assert pipe._modules_on(meta) == first          # kept while unchanged
    path = tmp_path / "unet.pt"
    torch.save({k: v + 1 if v.is_floating_point() else v
                for k, v in pipe.unet.state_dict().items()}, path)
    pipe.load_unet_state_dict(str(path))
    second = pipe._modules_on(meta)
    assert second[0] is not first[0] and second[1:] == first[1:]
    assert pipe.enable_int8(min_dim=32) > 0
    third = pipe._modules_on(meta)[0]
    assert third is not second[0]
    dtypes = {k: v.dtype for k, v in pipe.unet.state_dict().items()}
    assert torch.int8 in dtypes.values()
    assert {k: v.dtype for k, v in third.state_dict().items()} == dtypes


def test_batcher_serves_a_data_mesh_pipeline(sd_pipe):
    """The batcher's two-phase hook on a 2-slot data-mesh pipeline: each
    PNG row equals ``generate_batch`` on its slot's sub-batch."""
    from safe_denoiser_tpu_torch.serving import DynamicBatcher, GenRequest
    kw = dict(num_inference_steps=2, height=SIDE, width=SIDE)
    mesh_pipe = _sd_pipe(sd_pipe)
    mesh_pipe.enable_data_mesh(mesh=cpu_mesh(2))

    def dispatch(reqs):
        return mesh_pipe.dispatch_batch([r.prompt for r in reqs],
                                        [r.seed for r in reqs],
                                        [r.guidance_scale for r in reqs],
                                        **kw)

    batcher = DynamicBatcher(lambda reqs: dispatch(reqs).fetch(), 2,
                             max_delay_s=0.2, dispatch_batch=dispatch)
    prompts = ["a cat on a sofa", "the dog runs", "a red bus", "a tree"]
    try:
        futs = [batcher.submit(GenRequest(p, seed=i, guidance_scale=7.5))
                for i, p in enumerate(prompts)]
        rows = [f.result(timeout=300) for f in futs]
    finally:
        batcher.close()
    plain = _sd_pipe(sd_pipe)
    for i in range(0, 4, 2):
        for k in range(2):
            want = plain.generate_batch([prompts[i + k]], [i + k], [7.5],
                                        **kw)[0]
            np.testing.assert_array_equal(rows[i + k], want)


# --------------------------------------------------------------- training
def test_esd_step_under_a_data_model_mesh_matches_the_unsharded_step():
    """One ESD update with the batch over 'data' and the UNet's attention
    and GEGLU MLPs over 'model' (UNET_TP_RULES): loss and updated master
    weights as the unsharded step's (autograd through the slots' slices)."""
    import copy

    from safe_denoiser_tpu_torch.dryrun import seeded_, tiny_unet_config
    from safe_denoiser_tpu_torch.models import UNet2DConditionModel
    from safe_denoiser_tpu_torch.training.esd import (
        ESDConfig, make_esd_train_step, make_optimizer, module_apply_fn)

    unet = seeded_(UNet2DConditionModel(tiny_unet_config()), 0)
    rs = np.random.RandomState(11)
    x_t = torch.from_numpy(rs.randn(4, 4, 8, 8).astype(np.float32))
    ctx_c = torch.from_numpy(rs.randn(4, 7, 16).astype(np.float32))
    t = torch.tensor([500, 300, 700, 100])
    cfg = ESDConfig(learning_rate=1e-3)
    mesh = tpar.Mesh(np.asarray([CPU] * 4, dtype=object).reshape(2, 2),
                     ("data", "model"))
    results = []
    for sharded in (False, True):
        module = copy.deepcopy(unet)
        apply = module_apply_fn(module, torch.float32)
        if sharded:
            tpar.shard_params_tp(module, mesh, rules=tpar.UNET_TP_RULES)
            base = apply

            def apply(p, x, tt, c):
                return tpar.over_axis(mesh, "data",
                                      lambda a, b, cc: base(p, a, b, cc),
                                      x, tt, c)
        params = {k: p.detach().clone()
                  for k, p in unet.named_parameters()}
        frozen = {k: p.clone() for k, p in params.items()}
        opt = make_optimizer(cfg, params)
        step = make_esd_train_step(apply, cfg)
        _, _, loss = step(params, frozen, opt, x_t, t, ctx_c,
                          torch.zeros_like(ctx_c))
        results.append((loss, params))
    assert module.down_blocks[0].attentions[0].transformer_blocks[0] \
        .ff._tp is not None
    (l0, p0), (l1, p1) = results
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    # the gradients (AdamW's first step moves each weight by ~lr whatever
    # its gradient's size, so a gradient near 0 would amplify f32 noise)
    scale = max(float(p.grad.abs().max()) for p in p0.values())
    for k in p0:
        assert p1[k].grad is not None, k
        np.testing.assert_allclose(p1[k].grad.numpy(), p0[k].grad.numpy(),
                                   atol=1e-5 * scale, rtol=1e-4)
        assert not torch.equal(p1[k], unet.get_parameter(k)), k
