"""Closed-form cross-attention editing (UCE / RECE).

Counterpart of ``safe_denoiser_tpu/training/uce.py``: Unified Concept
Editing's ridge-regularized least-squares update of every cross-attention
K/V projection, and RECE's refinement loop that adds, each round, the
closed-form adversarial embedding that still regenerates the concept
under the edited weights. The edit solves in row space, on the flax
orientation of a weight (the port's ``weight.T``, [D_ctx, inner], applied
as ``x @ W``):

    A = sum_e c_e^T c_e s_e + sum_p c_p^T c_p s_p + lambda I    [D, D]
    B = sum_e c_e^T (t_e W0) s_e + sum_p c_p^T (c_p W0) s_p + lambda W0
    W' = A^-1 B

in f32 with ``torch.linalg.solve``; each weight keeps its storage dtype.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def cross_attn_kv_paths(params) -> list:
    """Names of every cross-attention K/V weight (``attn2.to_{k,v}``)."""
    return [n for n in params
            if "attn2" in n and ("to_k" in n or "to_v" in n)
            and n.endswith("weight")]


def _stack(states: Sequence) -> torch.Tensor:
    """[N, L, D] from a sequence of [L, D] token-state matrices, f32."""
    return torch.stack([torch.as_tensor(s).float() for s in states])


def uce_edit_kernel(w0: torch.Tensor, erase_c: torch.Tensor,
                    erase_t: torch.Tensor, preserve_c: torch.Tensor | None,
                    lamb: float = 0.5, erase_scale: float = 1.0,
                    preserve_scale: float = 1.0) -> torch.Tensor:
    """Edit ONE [D, inner] row-space weight. erase_c/erase_t: [N_e, L, D]
    token states of the concepts and their targets; preserve_c: [N_p, L,
    D]."""
    d = w0.shape[0]
    ce = erase_c.reshape(-1, d)
    te = erase_t.reshape(-1, d)
    a = erase_scale * (ce.T @ ce) + lamb * torch.eye(d, dtype=torch.float32,
                                                     device=w0.device)
    b = erase_scale * (ce.T @ (te @ w0)) + lamb * w0
    if preserve_c is not None and preserve_c.numel():
        cp = preserve_c.reshape(-1, d)
        a = a + preserve_scale * (cp.T @ cp)
        b = b + preserve_scale * (cp.T @ (cp @ w0))
    return torch.linalg.solve(a, b).to(w0.dtype)


def uce_edit(params, erase_c: Sequence, erase_t: Sequence,
             preserve_c: Sequence = (), lamb: float = 0.5,
             erase_scale: float = 1.0, preserve_scale: float = 1.0) -> dict:
    """UCE on every cross-attention K/V weight of ``params`` ({name:
    tensor}): ``erase_c[i]``/``erase_t[i]`` the [L, D] token states of
    concept i and of the prompt it is remapped to, ``preserve_c`` states
    whose images must not move. Returns a new dict; every other entry is
    the same tensor."""
    if len(erase_c) != len(erase_t):
        raise ValueError("erase_c and erase_t must pair up")
    out = dict(params)
    paths = cross_attn_kv_paths(params)
    if not paths:
        return out
    dev = params[paths[0]].device
    ec, et = _stack(erase_c).to(dev), _stack(erase_t).to(dev)
    pc = _stack(preserve_c).to(dev) if len(preserve_c) else None
    for name in paths:
        w = params[name]
        w1 = uce_edit_kernel(w.float().T, ec, et, pc, lamb, erase_scale,
                             preserve_scale)
        out[name] = w1.T.contiguous().to(w.dtype)
    return out


def rece_adversarial_states(params_edited, params_orig,
                            concept_c: torch.Tensor) -> torch.Tensor:
    """RECE's closed-form adversarial embedding: the token states e* that
    best regenerate the erased concept's original K/V images under the
    edited weights, e* = c (sum W W'^T) (sum W' W'^T)^-1 over every edited
    projection (row-space weights)."""
    paths = cross_attn_kv_paths(params_orig)
    c = torch.as_tensor(concept_c).float()
    d = c.shape[-1]
    dev = params_orig[paths[0]].device
    num = torch.zeros((d, d), dtype=torch.float32, device=dev)
    den = torch.zeros((d, d), dtype=torch.float32, device=dev)
    for name in paths:
        w0 = params_orig[name].float().T
        w1 = params_edited[name].float().T
        num = num + w0 @ w1.T
        den = den + w1 @ w1.T
    # solve e* den = c num (a right division, as the transposed system)
    return torch.linalg.solve(den.T, (c.to(dev) @ num).T).T


def rece_edit(params, erase_c: Sequence, erase_t: Sequence,
              preserve_c: Sequence = (), iterations: int = 3,
              lamb: float = 0.5, erase_scale: float = 1.0,
              preserve_scale: float = 1.0, regularize: float = 1e-1) -> dict:
    """RECE: UCE, then ``iterations`` rounds of (adversarial embedding of
    each original concept, shrunk toward its target by ``regularize``,
    added to the erase set; UCE again from the original weights)."""
    dev = params[cross_attn_kv_paths(params)[0]].device
    orig_c = [torch.as_tensor(c).float().to(dev) for c in erase_c]
    orig_t = [torch.as_tensor(t).float().to(dev) for t in erase_t]
    cur_c, cur_t = list(orig_c), list(orig_t)
    edited = uce_edit(params, cur_c, cur_t, preserve_c, lamb, erase_scale,
                      preserve_scale)
    for _ in range(iterations):
        adv = [rece_adversarial_states(edited, params, c) for c in orig_c]
        adv = [(1.0 - regularize) * a + regularize * t
               for a, t in zip(adv, orig_t)]
        cur_c, cur_t = cur_c + adv, cur_t + list(orig_t)
        edited = uce_edit(params, cur_c, cur_t, preserve_c, lamb,
                          erase_scale, preserve_scale)
    return edited


def edit_unet_concepts(params, encode_fn: Callable[[str], torch.Tensor],
                       erase: Sequence[str],
                       targets: Sequence[str] | None = None,
                       preserve: Sequence[str] = (), method: str = "uce",
                       lamb: float = 0.5, erase_scale: float = 1.0,
                       preserve_scale: float = 1.0,
                       rece_iterations: int = 3) -> dict:
    """String-level entry: encode the prompts with ``encode_fn`` (str ->
    [L, D] final text-encoder states) and run the chosen editor."""
    targets = list(targets) if targets is not None else [""] * len(erase)
    if len(targets) != len(erase):
        raise ValueError("one target per erased concept")
    ec = [encode_fn(c) for c in erase]
    et = [encode_fn(t) for t in targets]
    pc = [encode_fn(p) for p in preserve]
    if method == "uce":
        return uce_edit(params, ec, et, pc, lamb, erase_scale,
                        preserve_scale)
    if method == "rece":
        return rece_edit(params, ec, et, pc, rece_iterations, lamb,
                         erase_scale, preserve_scale)
    raise ValueError(f"unknown edit method: {method!r}")
