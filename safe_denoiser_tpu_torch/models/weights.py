"""Checkpoint loading for the port: component configs from ``config.json``
and HF-layout state dicts (``.safetensors`` shards or torch ``.bin``/``.pt``).

Counterpart of the loaders in ``safe_denoiser_tpu/models/weights.py``. The
port's modules carry diffusers/HF parameter names, so a loaded state dict
goes into ``load_state_dict(strict=True)`` without conversion. The
safetensors reader is self-contained (numpy + torch): no safetensors
package is needed.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .clip_text import CLIP_VIT_L_14
from .mmdit import SD3_MEDIUM
from .t5 import T5_XXL
from .unet import SD14_UNET
from .vae import SD14_VAE


def load_component_config(model_dir: str, kind: str):
    """Config dataclass of 'unet' | 'vae' | 'clip_text' | 'mmdit' | 't5'
    from a diffusers/HF ``config.json``; the SD-v1.4 (SD3-medium, T5-XXL)
    preset when there is none."""
    defaults = {"unet": SD14_UNET, "vae": SD14_VAE,
                "clip_text": CLIP_VIT_L_14, "mmdit": SD3_MEDIUM,
                "t5": T5_XXL}[kind]
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return defaults
    with open(path) as f:
        cfg = json.load(f)
    if kind == "unet":
        heads = cfg.get("attention_head_dim", 8)
        if isinstance(heads, list):
            heads = heads[0]
        return dataclasses.replace(
            defaults,
            sample_size=cfg.get("sample_size", 64),
            in_channels=cfg.get("in_channels", 4),
            out_channels=cfg.get("out_channels", 4),
            block_out_channels=tuple(cfg.get("block_out_channels",
                                             (320, 640, 1280, 1280))),
            layers_per_block=cfg.get("layers_per_block", 2),
            cross_attention_dim=cfg.get("cross_attention_dim", 768),
            num_attention_heads=heads,
            norm_num_groups=cfg.get("norm_num_groups", 32),
            norm_eps=cfg.get("norm_eps", 1e-5),
            freq_shift=cfg.get("freq_shift", 0),
            flip_sin_to_cos=cfg.get("flip_sin_to_cos", True))
    if kind == "vae":
        return dataclasses.replace(
            defaults,
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            latent_channels=cfg.get("latent_channels", 4),
            block_out_channels=tuple(cfg.get("block_out_channels",
                                             (128, 256, 512, 512))),
            layers_per_block=cfg.get("layers_per_block", 2),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            scaling_factor=cfg.get("scaling_factor", 0.18215),
            shift_factor=cfg.get("shift_factor") or 0.0,
            sample_size=cfg.get("sample_size", 512),
            use_quant_conv=cfg.get("use_quant_conv", True),
            use_post_quant_conv=cfg.get("use_post_quant_conv", True))
    if kind == "mmdit":
        return dataclasses.replace(
            defaults,
            sample_size=cfg.get("sample_size", 128),
            patch_size=cfg.get("patch_size", 2),
            in_channels=cfg.get("in_channels", 16),
            out_channels=cfg.get("out_channels", 16),
            num_layers=cfg.get("num_layers", 24),
            num_heads=cfg.get("num_attention_heads", 24),
            head_dim=cfg.get("attention_head_dim", 64),
            joint_attention_dim=cfg.get("joint_attention_dim", 4096),
            caption_projection_dim=cfg.get("caption_projection_dim", 1536),
            pooled_projection_dim=cfg.get("pooled_projection_dim", 2048),
            pos_embed_max_size=cfg.get("pos_embed_max_size", 192),
            qk_norm=cfg.get("qk_norm"))
    if kind == "t5":
        return dataclasses.replace(
            defaults,
            vocab_size=cfg.get("vocab_size", 32128),
            d_model=cfg.get("d_model", 4096),
            d_kv=cfg.get("d_kv", 64),
            d_ff=cfg.get("d_ff", 10240),
            num_layers=cfg.get("num_layers", 24),
            num_heads=cfg.get("num_heads", 64),
            relative_attention_num_buckets=cfg.get(
                "relative_attention_num_buckets", 32),
            relative_attention_max_distance=cfg.get(
                "relative_attention_max_distance", 128))
    return dataclasses.replace(
        defaults,
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 768),
        num_layers=cfg.get("num_hidden_layers", 12),
        num_heads=cfg.get("num_attention_heads", 12),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        intermediate_size=cfg.get("intermediate_size", 3072),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        projection_dim=cfg.get("projection_dim", 768),
        eos_token_id=cfg.get("eos_token_id", 49407))


_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _read_safetensors_header(path: str) -> tuple[dict, int]:
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    return header, 8 + n


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read a .safetensors file into CPU tensors (the file is memory-mapped
    and each tensor copied out)."""
    header, base = _read_safetensors_header(path)
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    out: dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        tag = meta["dtype"]
        if tag not in _ST_DTYPES:
            raise NotImplementedError(f"safetensors dtype {tag} in {path}")
        o0, o1 = meta["data_offsets"]
        raw = torch.from_numpy(np.array(buf[base + o0:base + o1]))
        out[name] = raw.view(_ST_DTYPES[tag]).reshape(meta["shape"])
    return out


def safetensors_metadata(path: str) -> dict[str, str]:
    """The ``__metadata__`` block of a .safetensors file ({} if none)."""
    return dict(_read_safetensors_header(path)[0].get("__metadata__") or {})


_ST_TAGS = {v: k for k, v in _ST_DTYPES.items()}


def save_safetensors(path: str, tensors: dict, metadata: dict | None = None
                     ) -> None:
    """Write ``tensors`` ({name: tensor}) as a .safetensors file: an 8-byte
    header length, the JSON header (each tensor's dtype, shape and byte
    range, and ``metadata`` as ``__metadata__`` strings), then the raw
    data. Written to ``path + ".tmp"`` and moved into place."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name, t in tensors.items():
        flat = t.detach().contiguous().cpu().reshape(-1)
        n = flat.numel() * flat.element_size()
        header[name] = {"dtype": _ST_TAGS[flat.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        blobs.append(flat)
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for flat in blobs:
            f.write(flat.view(torch.uint8).numpy().tobytes())
    os.replace(tmp, path)


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A flat {key: tensor} state dict from .safetensors/.pt/.bin."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def load_sharded_state_dict(model_dir: str) -> dict[str, torch.Tensor]:
    """The .safetensors shard set of an HF model directory: an
    ``*.safetensors.index.json`` names the shards; precision variants
    (``*.fp16.*``, ``*.non_ema.*``) are skipped when base files exist; torch
    ``.bin``/``.pt`` files are read when there is no safetensors file."""
    names = sorted(os.listdir(model_dir))

    def is_variant(n):
        return any(f".{v}." in n for v in ("fp16", "non_ema"))

    index = [n for n in names if n.endswith(".safetensors.index.json")]
    if any(not is_variant(n) for n in index):
        index = [n for n in index if not is_variant(n)]
    if index:
        with open(os.path.join(model_dir, index[0])) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out: dict[str, torch.Tensor] = {}
        for fname in shards:
            out.update(load_state_dict(os.path.join(model_dir, fname)))
        return out
    st = [n for n in names if n.endswith(".safetensors")]
    if any(not is_variant(n) for n in st):
        st = [n for n in st if not is_variant(n)]
    out = {}
    for fname in st:
        out.update(load_state_dict(os.path.join(model_dir, fname)))
    if not out:
        for fname in names:
            if fname.endswith((".bin", ".pt")):
                out.update(load_state_dict(os.path.join(model_dir, fname)))
    return out


def clip_vision_state_dict(sd: dict, projection_dim: int = 768) -> dict:
    """An HF CLIP vision state dict (``CLIPVisionModel[WithProjection]``,
    with or without the ``vision_model.`` prefix; other towers' keys beside
    a prefixed one are dropped) in the port's key set:
    the pre-LN under HF's ``pre_layrnorm`` whichever spelling the file
    has, the ``position_ids`` buffer dropped, and an identity
    ``visual_projection`` of ``projection_dim`` rows where the file has no
    projection head (as the JAX package's converter)."""
    ours = ("vision_model.", "visual_projection.")
    prefixed = any(k.startswith("vision_model.") for k in sd)
    out = {}
    for k, v in sd.items():
        if prefixed and not k.startswith(ours):
            continue                          # e.g. a whole CLIPModel's text
        if not k.startswith(ours):
            k = "vision_model." + k
        out[k.replace(".pre_layernorm.", ".pre_layrnorm.")] = v
    out.pop("vision_model.embeddings.position_ids", None)
    if "visual_projection.weight" not in out:
        hidden = out["vision_model.post_layernorm.weight"].shape[0]
        out["visual_projection.weight"] = torch.eye(projection_dim, hidden)
    return out


def t5_state_dict(sd: dict) -> dict:
    """An HF ``T5EncoderModel`` state dict in the port's key set: the token
    table under ``shared.weight`` (HF ties it to
    ``encoder.embed_tokens.weight`` and a checkpoint may hold either or
    both), everything else as it is."""
    sd = dict(sd)
    tied = sd.pop("encoder.embed_tokens.weight", None)
    if "shared.weight" not in sd and tied is not None:
        sd["shared.weight"] = tied
    return sd


def clip_text_state_dict(sd: dict, projection_dim: int) -> dict:
    """An HF CLIP text state dict (``CLIPTextModel[WithProjection]``, with
    or without the ``text_model.`` prefix; other towers' keys beside a
    prefixed one are dropped) in the key set of ``CLIPTextModel(...,
    with_projection=True)``: the ``position_ids`` buffer dropped, and an
    identity ``text_projection`` of ``projection_dim`` rows where the file
    has no projection head (as the JAX package's converter)."""
    ours = ("text_model.", "text_projection.")
    prefixed = any(k.startswith("text_model.") for k in sd)
    out = {}
    for k, v in sd.items():
        if prefixed and not k.startswith(ours):
            continue                          # e.g. a whole CLIPModel's vision
        out[k if k.startswith(ours) else "text_model." + k] = v
    out.pop("text_model.embeddings.position_ids", None)
    if "text_projection.weight" not in out:
        hidden = out["text_model.final_layer_norm.weight"].shape[0]
        out["text_projection.weight"] = torch.eye(projection_dim, hidden)
    return out


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def as_tensors(sd: dict) -> dict[str, torch.Tensor]:
    """A state dict of numpy arrays and/or tensors (any dtype) as tensors,
    for ``Module.load_state_dict``, which casts them to the module's."""
    return {k: _tensor(v) for k, v in sd.items()}


def _open_clip_layers(sd: dict, src: str, dst: str, n: int) -> dict:
    """OpenCLIP residual blocks ``<src>.i`` as HF encoder layers
    ``<dst>.i``: the packed ``in_proj`` split into q, k and v."""
    out = {}
    for i in range(n):
        s, d = f"{src}.{i}", f"{dst}.{i}"
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            for part in ("weight", "bias"):
                packed = _tensor(sd[f"{s}.attn.in_proj_{part}"])
                out[f"{d}.self_attn.{name}.{part}"] = packed.chunk(3)[j]
        for theirs, mine in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                             ("attn.out_proj", "self_attn.out_proj"),
                             ("mlp.c_fc", "mlp.fc1"),
                             ("mlp.c_proj", "mlp.fc2")):
            for part in ("weight", "bias"):
                out[f"{d}.{mine}.{part}"] = sd[f"{s}.{theirs}.{part}"]
    return out


def open_clip_vision_state_dict(sd: dict, cfg) -> dict:
    """An OpenCLIP/OpenAI-CLIP checkpoint's ``visual.*`` keys as a
    ``CLIPVisionModel`` state dict (the JAX package's
    ``convert_open_clip_vision``). ``visual.proj`` is right-multiplied,
    [width, out], so it goes in transposed as an HF Linear weight."""
    p = "visual."
    out = {
        "vision_model.embeddings.class_embedding":
            _tensor(sd[f"{p}class_embedding"]).reshape(-1),
        "vision_model.embeddings.position_embedding.weight":
            sd[f"{p}positional_embedding"],
        "vision_model.embeddings.patch_embedding.weight":
            sd[f"{p}conv1.weight"],
        "visual_projection.weight":
            _tensor(sd[f"{p}proj"]).T.contiguous(),
    }
    for theirs, mine in (("ln_pre", "pre_layrnorm"),
                         ("ln_post", "post_layernorm")):
        for part in ("weight", "bias"):
            out[f"vision_model.{mine}.{part}"] = sd[f"{p}{theirs}.{part}"]
    out.update(_open_clip_layers(sd, f"{p}transformer.resblocks",
                                 "vision_model.encoder.layers",
                                 cfg.num_layers))
    return out


def open_clip_text_state_dict(sd: dict, cfg) -> dict:
    """An OpenCLIP/OpenAI-CLIP checkpoint's text keys as a
    ``CLIPTextModel(..., with_projection=True)`` state dict (the JAX
    package's ``convert_open_clip_text``); ``text_projection`` [width,
    out] goes in transposed."""
    out = {
        "text_model.embeddings.token_embedding.weight":
            sd["token_embedding.weight"],
        "text_model.embeddings.position_embedding.weight":
            sd["positional_embedding"],
        "text_model.final_layer_norm.weight": sd["ln_final.weight"],
        "text_model.final_layer_norm.bias": sd["ln_final.bias"],
        "text_projection.weight":
            _tensor(sd["text_projection"]).T.contiguous(),
    }
    out.update(_open_clip_layers(sd, "transformer.resblocks",
                                 "text_model.encoder.layers", cfg.num_layers))
    return out
