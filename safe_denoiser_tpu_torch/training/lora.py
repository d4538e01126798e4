"""LoRA adapters for the erasure trainers (parameter-efficient ESD / flow).

Counterpart of ``safe_denoiser_tpu/training/lora.py``. Only rank-r factors
of selected linear weights train; the base weights are never copied and
serve as both the frozen teacher and the student's base.

Adapter files interchange with the JAX package's: an adapter is
``{path: {"a": A, "b": B}}`` keyed by the JAX package's '/'-joined flax
path of the weight's ``kernel`` (``params/down_0_attentions_0/blocks_0/
attn2/to_k/kernel``), with A [in, r] and B [r, out] in flax's orientation.
The port's weight is the flax kernel transposed, [out, in], so a merge is
``W + scale (A @ B)^T``, accumulated in f32 and cast back to W's dtype
(a zero B gives W bit for bit). The path <-> port-name map comes from the
weight bridge (``models/weights_export.flax_linear_paths``); functions that
need it take the model's config (``UNetConfig`` or ``MMDiTConfig``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.weights import load_safetensors, safetensors_metadata, \
    save_safetensors
from ..models.weights_export import flax_linear_paths
from .esd import ESDConfig, esd_loss, optimizer_step

#: named target predicates over the '/'-joined flax path. Any other string
#: is a literal substring match (e.g. "ff" or "down_0").
LORA_TARGET_SETS = {
    "xattn": lambda s: "attn2" in s,
    "selfattn": lambda s: "attn1" in s,
    "attn": lambda s: "attn1" in s or "attn2" in s,
    # as esd_param_mask('noxattn'): no cross-attention, no top-level time
    # embedding (the per-resnet time_emb_proj stays in)
    "noxattn": lambda s: ("attn2" not in s and "time_emb_1" not in s
                          and "time_emb_2" not in s),
    "full": lambda s: True,
}


def lora_names(params, model_cfg) -> dict[str, str]:
    """{flax path: port weight name} of every linear weight of ``params``
    ({name: tensor}, the model's state dict names)."""
    return {path: name for name, path in
            flax_linear_paths(model_cfg, names=params).items()}


def lora_target_paths(params, targets: str = "xattn", *, model_cfg) -> list:
    """The flax paths of the linear weights LoRA attaches to, in the JAX
    package's walk order (its tree's sorted keys). ``targets``: a named
    set (xattn/selfattn/attn/noxattn/full) or a literal substring of the
    path. An integer (int8) target is refused."""
    pred = LORA_TARGET_SETS.get(targets) or (lambda s: targets in s)
    out = []
    for path, name in sorted(lora_names(params, model_cfg).items()):
        if not pred(path):
            continue
        w = params[name]
        if not torch.is_floating_point(w):
            raise ValueError(
                f"LoRA target {path} has integer dtype {w.dtype} — attach "
                "LoRA BEFORE enable_int8/quantize_*_params (adapters train "
                "on the float kernels).")
        out.append(path)
    if not out:
        raise ValueError(f"LoRA targets {targets!r} matched no 2-D kernel "
                         "leaves in the param tree")
    return out


def init_lora_params(params, generator: torch.Generator, rank: int,
                     targets: str = "xattn", dtype=torch.float32, *,
                     model_cfg) -> Dict[str, Dict[str, torch.Tensor]]:
    """A new adapter ``{path: {"a": [in, r], "b": [r, out]}}`` on
    ``params``' device: A ~ N(0, 1/in), B = 0 (the merged model starts equal
    to the base). A is drawn from ``generator``, one target after another
    (the JAX package folds its key per target: the draws differ)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    names = lora_names(params, model_cfg)
    lora = {}
    for path in lora_target_paths(params, targets, model_cfg=model_cfg):
        w = params[names[path]]
        d_out, d_in = w.shape
        a = torch.randn((d_in, rank), generator=generator,
                        device=generator.device) * d_in ** -0.5
        lora[path] = {"a": a.to(device=w.device, dtype=dtype),
                      "b": torch.zeros((rank, d_out), dtype=dtype,
                                       device=w.device)}
    return lora


def lora_scale(rank: int, alpha: float | None = None) -> float:
    """The merge coefficient alpha/rank (alpha defaults to rank => 1.0)."""
    return (rank if alpha is None else alpha) / rank


def apply_lora(params, lora, scale: float = 1.0, strict: bool = True, *,
               model_cfg) -> dict:
    """``params`` ({name: tensor}) with each adapted weight replaced by
    ``W + scale (A @ B)^T`` (f32 sums, W's dtype), the rest as they are.
    Differentiable in the adapter: call it inside the loss to train, or
    once to merge. ``strict`` raises on adapter entries that match no
    weight (a foreign adapter would otherwise merge as a silent no-op)."""
    names = lora_names(params, model_cfg)
    merged = dict(params)
    missing = []
    for path, ab in lora.items():
        name = names.get(path)
        if name is None:
            missing.append(path)
            continue
        w = params[name]
        delta = ab["a"].float() @ ab["b"].float()
        merged[name] = (w.float() + scale * delta.T).to(w.dtype)
    if strict and missing:
        missing.sort()
        raise ValueError(
            f"LoRA adapter has {len(missing)} entries matching no param "
            f"leaf (wrong model family or path layout?): "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    return merged


def merge_lora_into(params, path: str, scale: float | None = None, *,
                    model_cfg) -> dict:
    """Load an adapter file and return ``params`` with it merged in (the
    implementation behind both pipelines' ``load_lora``). ``scale``
    overrides the adapter's recorded alpha/rank. Refuses int8 weights
    (adapters apply to float kernels: load before ``enable_int8``) and
    adapters whose paths match no weight."""
    lora, meta = load_lora(path)
    if scale is None:
        scale = lora_scale(int(meta.get("rank", 1)), meta.get("alpha", None))
    if any(not torch.is_floating_point(w) for w in params.values()):
        raise ValueError(
            "load_lora after enable_int8: the adapter applies to float "
            "kernels. Load the adapter first, then enable_int8().")
    dev = next(iter(params.values())).device
    lora = {p: {k: v.to(dev) for k, v in ab.items()}
            for p, ab in lora.items()}
    with torch.no_grad():
        return apply_lora(params, lora, scale, model_cfg=model_cfg)


def make_lora_esd_train_step(apply_fn: Callable,
                             cfg: ESDConfig = ESDConfig(),
                             scale: float = 1.0, *, model_cfg) -> Callable:
    """One LoRA-ESD update: merge, loss, gradient, AdamW.

    ``step(lora, opt, params, x_t, t, ctx_c, ctx_u) -> (lora, opt, loss)``;
    ``params`` is the base, used for both the frozen teacher and the
    student's base and never updated; ``opt`` is ``make_optimizer(cfg,
    lora)``; the adapter is updated in place."""
    def step(lora, opt, params, x_t, t, ctx_c, ctx_u):
        merged = apply_lora(params, lora, scale, model_cfg=model_cfg)
        loss = esd_loss(apply_fn, merged, params, x_t, t, ctx_c, ctx_u,
                        cfg.negative_guidance)
        optimizer_step(opt, loss, cfg)
        return lora, opt, loss.detach()

    return step


def make_lora_train_step(loss_of_merged: Callable,
                         cfg: ESDConfig = ESDConfig(),
                         scale: float = 1.0, *, model_cfg) -> Callable:
    """A LoRA update for any loss over merged parameters (e.g. the SD3
    flow-matching loss): ``loss_of_merged(merged_params, *batch) ->
    scalar``. ``step(lora, opt, params, *batch) -> (lora, opt, loss)``."""
    def step(lora, opt, params, *batch):
        loss = loss_of_merged(apply_lora(params, lora, scale,
                                         model_cfg=model_cfg), *batch)
        optimizer_step(opt, loss, cfg)
        return lora, opt, loss.detach()

    return step


def save_lora(path: str, lora, rank: int, alpha: float | None = None,
              targets: str = "xattn", metadata: Dict[str, str] | None = None
              ) -> None:
    """Write an adapter: flat ``{path}.lora_a`` / ``{path}.lora_b`` tensors
    and its metadata (rank, alpha, targets, ``metadata``), as
    ``.safetensors`` (the metadata as strings) or, for any other suffix, a
    torch ``.pt`` of ``{"lora": tensors, "meta": meta}``: the JAX
    package's two formats."""
    flat = {}
    for p, ab in lora.items():
        flat[p + ".lora_a"] = ab["a"].detach().cpu().contiguous()
        flat[p + ".lora_b"] = ab["b"].detach().cpu().contiguous()
    meta = {"rank": rank, "alpha": lora_scale(rank, alpha) * rank,
            "targets": targets, **(metadata or {})}
    if path.endswith(".safetensors"):
        save_safetensors(path, flat, meta)
    else:
        torch.save({"lora": flat, "meta": meta}, path)


def load_lora(path: str):
    """Inverse of ``save_lora`` (and of the JAX package's) ->
    ``(adapter, meta)``, the tensors on the CPU."""
    if path.endswith(".safetensors"):
        flat = load_safetensors(path)
        meta = safetensors_metadata(path)
        if "rank" in meta:
            meta["rank"] = int(meta["rank"])
        if "alpha" in meta:
            meta["alpha"] = float(meta["alpha"])
    else:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        flat, meta = blob["lora"], dict(blob["meta"])
    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    unknown = []
    for k, v in flat.items():
        v = torch.as_tensor(v)
        if k.endswith(".lora_a"):
            lora.setdefault(k[:-len(".lora_a")], {})["a"] = v
        elif k.endswith(".lora_b"):
            lora.setdefault(k[:-len(".lora_b")], {})["b"] = v
        else:
            unknown.append(k)
    if unknown or not lora:
        raise ValueError(
            f"{path} is not a LoRA adapter file: "
            + (f"{len(unknown)} keys end in neither .lora_a nor .lora_b "
               f"({unknown[:3]}...)" if unknown else "no .lora_a/.lora_b "
               "tensors found"))
    for p, ab in lora.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(f"adapter file missing a/b pair for {p}")
    return lora, meta
