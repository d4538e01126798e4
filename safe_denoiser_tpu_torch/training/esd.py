"""Training steps: ESD concept erasure and the denoising fine-tune.

Counterpart of ``safe_denoiser_tpu/training/esd.py``. The JAX package
differentiates a flax module whose f32 parameters are cast to bf16 inside
its apply; here a step is a plain function over a module and its f32
master parameters (``{name: tensor}``, diffusers names): the forward calls
the module through ``torch.func.functional_call`` with the parameters cast
to the compute dtype inside the autograd graph (``module_apply_fn``), so
the gradients arrive in f32 on the master parameters. On the card the
UNet's self-attention, its large GroupNorms' statistics and its upsample
conv run through their kernels' autograd Functions (B1/B1b, B5/B5b,
B3/B3b, ``ops/``); every other kernel raises under autograd.

The optimizer is ``torch.optim.AdamW`` over the trainable subset only (the
counterpart of ``optax.multi_transform`` with ``set_to_zero``), with
optax's betas (0.9, 0.999) and eps 1e-8; it updates the master parameters
in place. Noise and timesteps are injected or drawn from an explicit
``torch.Generator``; the frozen teacher's forwards and the x_t draw run
under ``torch.no_grad()``, concept and uncond stacked into one batch as in
JAX. Layout: NCHW latents, as the port's UNet takes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.func import functional_call


@dataclass(frozen=True)
class ESDConfig:
    """Hyperparameters for ESD erasure fine-tuning."""
    negative_guidance: float = 1.0   # eta: the away-from-concept push
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0      # 0 = no clipping


def module_apply_fn(module: torch.nn.Module,
                    dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``apply_fn(params, *args) = module(*args)`` with ``params`` ({name:
    tensor}, any subset of the module's) cast to ``dtype`` inside the
    graph: the JAX package's ``module.apply`` with f32 parameters and a
    bf16 module. A parameter already in ``dtype`` is used as it is."""
    def apply(params, *args):
        return functional_call(module, {n: p.to(dtype)
                                        for n, p in params.items()}, args)
    return apply


def _draw_noise(noise, like: torch.Tensor) -> torch.Tensor:
    """``noise`` as given, or drawn from it when it is a generator."""
    if isinstance(noise, torch.Generator):
        return torch.randn(like.shape, generator=noise, device=like.device,
                           dtype=like.dtype)
    return noise


def add_noise(scheduler, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """The DDPM forward noising at per-sample t (the JAX scheduler's
    ``add_noise`` with a [B, 1, 1, 1] t): sqrt(a_t) x0 + sqrt(1 - a_t)
    noise, a_t the f32 cumulative alpha."""
    ac = torch.as_tensor(scheduler.alphas_cumprod, device=x0.device)
    a = ac[t.long()].reshape((-1,) + (1,) * (x0.dim() - 1))
    return a.sqrt() * x0 + (1.0 - a).sqrt() * noise


def ddpm_loss(apply_fn: Callable, params, scheduler, x0: torch.Tensor,
              ctx: torch.Tensor, t: torch.Tensor, noise) -> torch.Tensor:
    """The epsilon-prediction MSE ``|e_theta(add_noise(x0, eps, t), t, ctx) -
    eps|^2`` in f32. x0 [B, C, H, W] clean latents, ctx [B, S, D], t [B]
    int; ``noise``: eps, or a ``torch.Generator`` to draw it from (the JAX
    package's ``rng``)."""
    noise = _draw_noise(noise, x0)
    x_t = add_noise(scheduler, x0, noise, t)
    pred = apply_fn(params, x_t, t, ctx)
    return torch.mean(torch.square(pred.float() - noise.float()))


def esd_loss(apply_fn: Callable, params, frozen_params, x_t: torch.Tensor,
             t: torch.Tensor, ctx_concept: torch.Tensor,
             ctx_uncond: torch.Tensor,
             negative_guidance: float = 1.0) -> torch.Tensor:
    """The ESD erasure loss at one (x_t, t): ``target = e*(x_t,t,0) -
    eta (e*(x_t,t,c) - e*(x_t,t,0))`` with e* the frozen model (no
    gradient), loss ``|e_theta(x_t,t,c) - target|^2`` in f32. The two
    frozen forwards are one batched call, concept rows on uncond rows."""
    b = x_t.shape[0]
    with torch.no_grad():
        e_star = apply_fn(frozen_params, torch.cat([x_t, x_t]),
                          torch.cat([t, t]),
                          torch.cat([ctx_concept, ctx_uncond]))
    e_c, e_u = e_star[:b].float(), e_star[b:].float()
    target = e_u - negative_guidance * (e_c - e_u)
    pred = apply_fn(params, x_t, t, ctx_concept).float()
    return torch.mean(torch.square(pred - target))


# the CompVis ESD recipe's frozen top-level parts under noxattn:
# 'time_embed' and the output head ('out.': the final norm + conv)
_NOXATTN_FROZEN_TOP = ("time_embedding", "conv_norm_out", "conv_out")


def esd_param_mask(params, train_method: str) -> dict[str, bool]:
    """{name: trainable} over the UNet's parameters (diffusers names), the
    ESD recipe's subsets: ``xattn`` cross-attention only (``attn2``),
    ``selfattn`` self-attention only (``attn1``), ``noxattn`` everything
    but cross-attention, the top-level time embedding and the output head
    (the per-resnet ``time_emb_proj`` stays trainable), ``full``
    everything. The same leaves as the JAX package's mask on its flax
    paths."""
    def keep(name: str) -> bool:
        if train_method == "full":
            return True
        if train_method == "xattn":
            return "attn2" in name
        if train_method == "selfattn":
            return "attn1" in name
        if train_method == "noxattn":
            return ("attn2" not in name
                    and name.split(".")[0] not in _NOXATTN_FROZEN_TOP)
        raise ValueError(f"unknown train_method: {train_method!r}")

    return {name: keep(name) for name in params}


def _flat_tensors(params) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of a {name: tensor} dict or of a LoRA adapter
    ({path: {"a": A, "b": B}}), in its order."""
    out = []
    for name, v in params.items():
        if isinstance(v, dict):
            out += [(f"{name}.{k}", v[k]) for k in sorted(v)]
        else:
            out.append((name, v))
    return out


def make_optimizer(cfg: ESDConfig, params, param_mask=None
                   ) -> torch.optim.AdamW:
    """AdamW over the trainable tensors of ``params`` ({name: tensor} or a
    LoRA adapter): those ``param_mask`` selects (all without one). Those
    get ``requires_grad``, the rest lose it, so the frozen complement
    neither gets a gradient nor moves (optax's ``set_to_zero``). Global-norm
    clipping (``cfg.grad_clip_norm``) is applied by the train steps."""
    trainable = []
    for name, p in _flat_tensors(params):
        on = param_mask is None or bool(param_mask[name])
        p.requires_grad_(on)
        if on:
            trainable.append(p)
    return torch.optim.AdamW(trainable, lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def clip_by_global_norm(tensors, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the gradients, in place:
    g * min(1, max_norm / |g|) over the global norm of all of them."""
    grads = [p.grad for p in tensors if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))


def optimizer_step(opt: torch.optim.Optimizer, loss: torch.Tensor,
                   cfg: ESDConfig) -> None:
    """Backward, clip (``cfg.grad_clip_norm`` > 0), update."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if cfg.grad_clip_norm > 0:
        clip_by_global_norm([p for grp in opt.param_groups
                             for p in grp["params"]], cfg.grad_clip_norm)
    opt.step()


def make_esd_train_step(apply_fn: Callable, cfg: ESDConfig = ESDConfig()
                        ) -> Callable:
    """One ESD update: loss, gradient, AdamW.

    ``step(params, frozen_params, opt, x_t, t, ctx_c, ctx_u) -> (params,
    opt, loss)``; ``opt`` is ``make_optimizer(cfg, params, mask)``, which
    fixes the trainable subset, and the master ``params`` are updated in
    place. ``frozen_params`` must not share storage with ``params`` (copy
    them once at set-up, e.g. in the compute dtype)."""
    def step(params, frozen_params, opt, x_t, t, ctx_c, ctx_u):
        loss = esd_loss(apply_fn, params, frozen_params, x_t, t, ctx_c,
                        ctx_u, cfg.negative_guidance)
        optimizer_step(opt, loss, cfg)
        return params, opt, loss.detach()

    return step


def make_train_step(apply_fn: Callable, scheduler,
                    cfg: ESDConfig = ESDConfig()) -> Callable:
    """One denoising fine-tune update (epsilon MSE, AdamW).

    ``step(params, opt, x0, ctx, t, noise) -> (params, opt, loss)``;
    ``noise`` as ``ddpm_loss`` takes it."""
    def step(params, opt, x0, ctx, t, noise):
        loss = ddpm_loss(apply_fn, params, scheduler, x0, ctx, t, noise)
        optimizer_step(opt, loss, cfg)
        return params, opt, loss.detach()

    return step


@torch.no_grad()
def sample_xt_for_esd(apply_fn: Callable, frozen_params, scheduler,
                      ctx_concept: torch.Tensor, ctx_uncond: torch.Tensor,
                      generator: torch.Generator | None, shape: tuple,
                      num_steps: int = 3, guidance_scale: float = 3.0,
                      t_train: torch.Tensor | None = None,
                      x_init: torch.Tensor | None = None) -> tuple:
    """The ESD recipe's (x_t, t) training point: pure noise partially
    denoised toward the concept with the frozen model over ``num_steps``
    coarse CFG/DDIM steps (t = n-1, n-1-n/k, ...), then its x0 placed
    forward at a random training timestep. ``shape``: NCHW [B, 4, h, w].
    ``x_init`` and ``t_train`` inject the draws (tests feed the JAX
    package's); otherwise both come from ``generator``, x first, as JAX
    splits its key. Returns (x_t, t), no gradient."""
    dev = ctx_concept.device
    if x_init is None:
        x_init = torch.randn(shape, generator=generator, device=dev)
    n_train = scheduler.config.num_train_timesteps
    if t_train is None:
        t_train = torch.randint(0, n_train, (shape[0],), generator=generator,
                                device=dev)
    ac = torch.as_tensor(scheduler.alphas_cumprod, device=dev)
    b = shape[0]
    grid = [n_train - 1 - i * (n_train // num_steps)
            for i in range(num_steps)]
    x = x_init.float()
    x0 = x
    eps = torch.zeros_like(x)
    for i, t_i in enumerate(grid):
        t_b = torch.full((b,), t_i, dtype=torch.long, device=dev)
        both = apply_fn(frozen_params, torch.cat([x, x]),
                        torch.cat([t_b, t_b]),
                        torch.cat([ctx_concept, ctx_uncond]))
        e_c, e_u = both[:b].float(), both[b:].float()
        eps = e_u + guidance_scale * (e_c - e_u)
        a_t = ac[t_i]
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        if i + 1 < len(grid):        # DDIM hop to the next grid point
            a_n = ac[grid[i + 1]]
            x = torch.sqrt(a_n) * x0 + torch.sqrt(1.0 - a_n) * eps
    a_tr = ac[t_train.long()].reshape(-1, 1, 1, 1)
    x_t = torch.sqrt(a_tr) * x0 + torch.sqrt(1.0 - a_tr) * eps
    return x_t, t_train
