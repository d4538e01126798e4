"""The port's training steps against the JAX package's on the CPU
(``training/esd.py``, ``flow.py``, ``checkpoint.py``).

Both packages hold the same weights (a tiny f32 UNet or MMDiT filled from
numpy, loaded into the port through ``from_jax_params``) and take the same
inputs, the noise and timesteps drawn by JAX and injected into the port.
The UNet runs at 24x24 latents, so its level-0 self-attention (S = 576)
goes through the port's ``SelfAttention`` Function (B1's plain version and
plain backward on the CPU) while JAX differentiates its einsum path.
Gradients are compared leaf for leaf through the weight bridge.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.schedulers import DDPMScheduler as JDDPM
from safe_denoiser_tpu.training import esd as j_esd
from safe_denoiser_tpu.training import flow as j_flow
from safe_denoiser_tpu_torch.models import unet as t_unet
from safe_denoiser_tpu_torch.models.weights_export import from_jax_params
from safe_denoiser_tpu_torch.schedulers import DDPMScheduler as TDDPM
from safe_denoiser_tpu_torch.training import checkpoint as t_ckpt
from safe_denoiser_tpu_torch.training import esd as t_esd
from safe_denoiser_tpu_torch.training import flow as t_flow
from tests.test_torch_port_models import UNET_KW, jax_unet, torch_unet
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401
from tests.test_torch_port_sd3 import MMDIT_KW, jax_mmdit, torch_mmdit

# f32 on both sides: losses within 1e-5 relative; each gradient tensor
# within 2e-4 of its largest |entry| (sums in another order through a
# random UNet, the attention's backward from its formula in the port and
# by XLA's transpose in JAX)
LOSS_RTOL, GRAD_RTOL = 1e-5, 2e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _params(module):
    """The port's f32 master parameters, fresh leaves."""
    return {n: p.detach().clone().requires_grad_()
            for n, p in module.named_parameters()}


def _bridge(tree, cfg):
    """A JAX tree of the model's shape -> {port name: numpy}."""
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg)


def _assert_grads(got: dict, want: dict, tol=GRAD_RTOL):
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        g = np.zeros_like(w) if g is None else g.detach().numpy()
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= tol * scale, name


def _inputs(seed=3, b=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 24, 24, 4).astype(np.float32)
    ctx_c = rs.randn(b, 5, 32).astype(np.float32)
    ctx_u = rs.randn(b, 5, 32).astype(np.float32)
    t = np.array([981, 311][:b], np.int32)
    return x, ctx_c, ctx_u, t


@functools.lru_cache(maxsize=None)
def _j_esd_value_and_grad(model):
    """JAX's ESD loss and gradient, jitted once for the module's tests
    (the frozen tree and eta are arguments)."""
    def loss(p, frozen, x, t, ctx_c, ctx_u, eta):
        return j_esd.esd_loss(model.apply, p, frozen, x, t, ctx_c, ctx_u,
                              eta)
    return jax.jit(jax.value_and_grad(loss))


@pytest.fixture(scope="module")
def tiny():
    model, params = jax_unet()
    module = torch_unet(params)
    return model, params, module, t_unet.UNetConfig(**UNET_KW)


def test_esd_loss_and_gradient_match_jax(tiny):
    model, params, module, cfg = tiny
    x, ctx_c, ctx_u, t = _inputs()
    frozen = jax.tree_util.tree_map(lambda a: a * 1.01, params)
    loss_j, g_j = _j_esd_value_and_grad(model)(
        params, frozen, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx_c),
        jnp.asarray(ctx_u), 1.5)
    p = _params(module)
    fz = {k: torch.from_numpy(v)
          for k, v in _bridge(frozen, cfg).items()}
    apply_fn = t_esd.module_apply_fn(module, torch.float32)
    loss = t_esd.esd_loss(apply_fn, p, fz, _nchw(x), torch.from_numpy(t),
                          torch.from_numpy(ctx_c), torch.from_numpy(ctx_u),
                          1.5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    _assert_grads({n: v.grad for n, v in p.items()}, _bridge(g_j, cfg))


def test_ddpm_loss_and_gradient_match_jax(tiny):
    model, params, module, cfg = tiny
    x0, ctx, _, t = _inputs(4, b=2)
    rng = jax.random.PRNGKey(5)
    noise = jax.random.normal(rng, x0.shape, dtype=jnp.float32)
    sched_j = JDDPM()
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda p: j_esd.ddpm_loss(
        model.apply, p, sched_j, jnp.asarray(x0), jnp.asarray(ctx),
        jnp.asarray(t), rng)))(params)
    p = _params(module)
    loss = t_esd.ddpm_loss(t_esd.module_apply_fn(module, torch.float32), p,
                           TDDPM(), _nchw(x0), torch.from_numpy(ctx),
                           torch.from_numpy(t).long(), _nchw(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    _assert_grads({n: v.grad for n, v in p.items()}, _bridge(g_j, cfg))


@pytest.mark.parametrize("method", ["noxattn", "xattn", "selfattn", "full"])
def test_esd_param_mask_matches_jax(tiny, method):
    """Leaf for leaf through the bridge, and the same trainable count."""
    _, params, module, cfg = tiny
    mask_j = j_esd.esd_param_mask(params, method)
    full = jax.tree_util.tree_map(lambda m, a: np.full(np.shape(a), m),
                                  mask_j, params)
    want = {k: bool(v.all()) for k, v in _bridge(full, cfg).items()}
    assert all(v.all() == v.any() for v in _bridge(full, cfg).values())
    got = t_esd.esd_param_mask(dict(module.named_parameters()), method)
    assert got == want
    n_j = sum(int(np.size(a)) for a, m in
              zip(jax.tree_util.tree_leaves(params),
                  jax.tree_util.tree_leaves(mask_j)) if m)
    n_t = sum(p.numel() for n, p in module.named_parameters() if got[n])
    assert n_t == n_j


def test_esd_train_steps_match_jax(tiny):
    """Three noxattn steps at lr 1e-4 (clipping at 1.0, weight decay
    0.01): the first step's gradients directly (its AdamW update is about
    sign(g) lr, which would hide them), each step's loss, and the
    parameters after three steps: frozen ones unchanged; trained ones
    within 2e-2 lr of JAX's where the two first gradients agree within 1%
    (AdamW's step is about lr g/|g|, so equal gradients give equal steps),
    and within the three steps' reach, 6 lr, on the others: elements whose
    gradient is ~0 against its tensor's, where f32 round-off in either
    package decides the step's size. Those are at most 5% of the
    elements."""
    model, params, module, cfg = tiny
    x, ctx_c, ctx_u, t = _inputs(6)
    conf = t_esd.ESDConfig(learning_rate=1e-4, weight_decay=0.01,
                           grad_clip_norm=1.0, negative_guidance=1.0)
    jconf = j_esd.ESDConfig(learning_rate=1e-4, weight_decay=0.01,
                            grad_clip_norm=1.0, negative_guidance=1.0)
    mask_j = j_esd.esd_param_mask(params, "noxattn")
    step_j = j_esd.make_esd_train_step(model.apply, jconf, donate=False,
                                       param_mask=mask_j)
    opt_j = j_esd.make_optimizer(jconf, mask_j).init(params)
    frozen_j = jax.tree_util.tree_map(jnp.copy, params)
    p_j = params
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx_c),
            jnp.asarray(ctx_u))
    _, g_j = _j_esd_value_and_grad(model)(params, frozen_j, *args, 1.0)

    p = _params(module)
    frozen = {n: v.detach().clone() for n, v in p.items()}
    mask = t_esd.esd_param_mask(p, "noxattn")
    opt = t_esd.make_optimizer(conf, p, mask)
    step = t_esd.make_esd_train_step(
        t_esd.module_apply_fn(module, torch.float32), conf)
    targs = (_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx_c),
             torch.from_numpy(ctx_u))
    want_g = _bridge(g_j, cfg)
    for i in range(3):
        p_j, opt_j, loss_j = step_j(p_j, frozen_j, opt_j, *args)
        if i == 0:
            loss = t_esd.esd_loss(
                t_esd.module_apply_fn(module, torch.float32), p, frozen,
                *targs)
            loss.backward()
            g_t = {n: v.grad.numpy().copy() for n, v in p.items()
                   if mask[n]}
            _assert_grads({n: v.grad if mask[n] else None
                           for n, v in p.items()},
                          {n: w if mask[n] else np.zeros_like(w)
                           for n, w in want_g.items()})
        _, opt, loss = step(p, frozen, opt, *targs)
        np.testing.assert_allclose(loss.item(), float(loss_j),
                                   rtol=LOSS_RTOL)
    want = _bridge(p_j, cfg)
    start = dict(module.named_parameters())
    loose = total = 0
    for n, v in p.items():
        if not mask[n]:
            assert torch.equal(v.detach(), start[n].detach()), n
            continue
        n_loose = _assert_adam_close(v, want[n], g_t[n], want_g[n], 1e-4, 3,
                                     n)
        loose += n_loose
        total += v.numel()
    assert loose <= 0.05 * total


def _assert_adam_close(v, want, g_t, g_j, lr, steps, name) -> int:
    """AdamW-updated ``v`` against JAX's ``want``: within 2e-2 lr where the
    two first gradients agree within 1%, within the steps' reach (2 lr a
    step) elsewhere; returns the count of the latter."""
    firm = np.abs(g_t - g_j) <= 1e-2 * np.abs(g_j)
    d = np.abs(v.detach().numpy() - want)
    assert d[firm].max(initial=0) <= 2e-2 * lr, name
    assert d.max() <= 2 * steps * lr, name
    return int((~firm).sum())


def test_clip_by_global_norm_is_optax():
    import optax
    rs = np.random.RandomState(7)
    gs = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    for c in (0.5, 100.0):
        want = optax.clip_by_global_norm(c).update(
            [jnp.asarray(g) for g in gs], None)[0]
        ps = [torch.zeros(g.shape, requires_grad=True) for g in gs]
        for p_, g in zip(ps, gs):
            p_.grad = torch.from_numpy(g.copy())
        t_esd.clip_by_global_norm(ps, c)
        for p_, w in zip(ps, want):
            np.testing.assert_allclose(p_.grad.numpy(), np.asarray(w),
                                       rtol=1e-6)


def test_sample_xt_for_esd_matches_jax(tiny):
    """On JAX's draws (the key split into the initial noise and t)."""
    model, params, module, cfg = tiny
    _, ctx_c, ctx_u, _ = _inputs(8, b=2)
    rng = jax.random.PRNGKey(9)
    sched_j = JDDPM()
    want_x, want_t = jax.jit(lambda p, c, u, r: j_esd.sample_xt_for_esd(
        model.apply, p, sched_j, c, u, r, (2, 24, 24, 4), num_steps=3,
        guidance_scale=3.0))(params, jnp.asarray(ctx_c), jnp.asarray(ctx_u),
                             rng)
    k_init, k_t = jax.random.split(rng)
    x_init = jax.random.normal(k_init, (2, 24, 24, 4), dtype=jnp.float32)
    t_train = jax.random.randint(k_t, (2,), 0, 1000)
    p = {n: v.detach() for n, v in module.named_parameters()}
    got_x, got_t = t_esd.sample_xt_for_esd(
        t_esd.module_apply_fn(module, torch.float32), p, TDDPM(),
        torch.from_numpy(ctx_c),
        torch.from_numpy(ctx_u), None, (2, 4, 24, 24), num_steps=3,
        guidance_scale=3.0, t_train=torch.from_numpy(np.array(t_train)),
        x_init=_nchw(x_init))
    assert got_x.grad_fn is None
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_x.numpy(), _nchw(want_x).numpy(),
                               rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------- flow (SD3)
@pytest.fixture(scope="module")
def tiny_mmdit():
    from safe_denoiser_tpu_torch.models import mmdit as t_mmdit
    model, params = jax_mmdit()
    return model, params, torch_mmdit(params), t_mmdit.MMDiTConfig(
        **MMDIT_KW)


def _flow_inputs(seed=13):
    rs = np.random.RandomState(seed)
    x0 = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 5, 24).astype(np.float32)
    pooled = rs.randn(2, 20).astype(np.float32)
    return x0, ctx, pooled


def test_flow_loss_gradient_and_step_match_jax(tiny_mmdit):
    model, params, module, cfg = tiny_mmdit
    x0, ctx, pooled = _flow_inputs()
    rng = jax.random.PRNGKey(14)
    sigma = j_flow.sample_sigmas_logit_normal(jax.random.PRNGKey(15), 2)
    noise = jax.random.normal(rng, x0.shape, dtype=jnp.float32)
    args_j = (jnp.asarray(x0), jnp.asarray(ctx), jnp.asarray(pooled), sigma,
              rng)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p: j_flow.flow_matching_loss(model.apply, p, *args_j)))(params)
    p = _params(module)
    apply_fn = t_esd.module_apply_fn(module, torch.float32)
    targs = (_nchw(x0), torch.from_numpy(ctx), torch.from_numpy(pooled),
             torch.from_numpy(np.asarray(sigma)), _nchw(noise))
    loss = t_flow.flow_matching_loss(apply_fn, p, *targs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    want_g = _bridge(g_j, cfg)
    _assert_grads({n: v.grad for n, v in p.items()}, want_g)
    g_t = {n: v.grad.numpy().copy() for n, v in p.items()}
    # one step at lr 1e-4 (no mask): the same parameters, as in
    # test_esd_train_steps_match_jax
    jconf = j_esd.ESDConfig(learning_rate=1e-4)
    step_j = j_flow.make_flow_train_step(model.apply, jconf, donate=False)
    p_j, _, loss_j = step_j(params, j_esd.make_optimizer(jconf).init(params),
                            *args_j)
    p = _params(module)
    conf = t_esd.ESDConfig(learning_rate=1e-4)
    step = t_flow.make_flow_train_step(apply_fn, conf)
    _, _, loss = step(p, t_esd.make_optimizer(conf, p), *targs)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=LOSS_RTOL)
    want = _bridge(p_j, cfg)
    loose = sum(_assert_adam_close(v, want[n], g_t[n], want_g[n], 1e-4, 1,
                                   n) for n, v in p.items())
    assert loose <= 0.05 * sum(v.numel() for v in p.values())


def test_sigmas_are_logit_normal():
    g = torch.Generator().manual_seed(0)
    s = t_flow.sample_sigmas_logit_normal(g, 20000, mean=0.5, std=0.8)
    z = torch.logit(s)
    assert abs(z.mean().item() - 0.5) < 0.03
    assert abs(z.std().item() - 0.8) < 0.03


# ----------------------------------------------------------- checkpoints
def _run(module, p, opt, step, steps, gen, shape, ctx_c, ctx_u):
    apply_fn = t_esd.module_apply_fn(module, torch.float32)
    frozen = {n: v.detach() for n, v in module.named_parameters()}
    for _ in range(steps):
        x_t, t = t_esd.sample_xt_for_esd(apply_fn, frozen, TDDPM(), ctx_c,
                                         ctx_u, gen, shape, num_steps=2)
        step(p, frozen, opt, x_t, t, ctx_c, ctx_u)


def test_checkpoint_resume_is_bit_identical(tiny, tmp_path):
    """Three steps straight against two, a snapshot, a restore into fresh
    tensors, optimizer and generator, and the third."""
    _, _, module, _ = tiny
    _, ctx_c, ctx_u, _ = _inputs(10)
    ctx_c, ctx_u = torch.from_numpy(ctx_c), torch.from_numpy(ctx_u)
    conf = t_esd.ESDConfig(learning_rate=1e-3)
    step = t_esd.make_esd_train_step(
        t_esd.module_apply_fn(module, torch.float32), conf)
    shape = (1, 4, 24, 24)

    def fresh():
        p = _params(module)
        mask = t_esd.esd_param_mask(p, "noxattn")
        return p, t_esd.make_optimizer(conf, p, mask)

    p_a, opt_a = fresh()
    _run(module, p_a, opt_a, step, 3, torch.Generator().manual_seed(1),
         shape, ctx_c, ctx_u)
    p_b, opt_b = fresh()
    gen = torch.Generator().manual_seed(1)
    _run(module, p_b, opt_b, step, 2, gen, shape, ctx_c, ctx_u)
    path = str(tmp_path / "state")
    t_ckpt.save_train_state(path, p_b, opt_b, 2, gen, {"lora_rank": 0})
    p_c, opt_c = fresh()
    gen_c = torch.Generator().manual_seed(99)
    _, _, it, _, meta = t_ckpt.restore_train_state(path, p_c, opt_c, gen_c)
    assert it == 2 and meta == {"lora_rank": 0}
    _run(module, p_c, opt_c, step, 1, gen_c, shape, ctx_c, ctx_u)
    for n in p_a:
        assert torch.equal(p_a[n], p_c[n]), n


def test_restore_refuses_a_changed_shape(tmp_path):
    a = {"w": torch.zeros(3, 4, requires_grad=True)}
    opt = t_esd.make_optimizer(t_esd.ESDConfig(), a)
    path = str(tmp_path / "state")
    t_ckpt.save_train_state(path, a, opt, 1)
    b = {"w": torch.zeros(3, 5, requires_grad=True)}
    with pytest.raises(ValueError, match="params leaf w has shape .* but "
                       "the live template expects"):
        t_ckpt.restore_train_state(path, b, t_esd.make_optimizer(
            t_esd.ESDConfig(), b))
