"""The weight bridge: JAX-package parameter trees (as numpy) -> the port's
diffusers/HF state dicts.

``from_jax_params(params, cfg)`` inverts the JAX package's converters for
the UNet (``invert_unet``), the VAE (``invert_vae``), the CLIP text
encoders (``convert_clip_text``: CLIP-L and bigG), the CLIP vision tower
(``convert_clip_vision``), the SD3 MMDiT (``convert_mmdit``), the T5
encoder (``convert_t5``) and the FID InceptionV3
(``evals/inception.py::convert_inception``), so both packages
can compute with the same weights. Pure numpy; the JAX tree is a nested dict of
arrays, optionally under a top-level ``"params"`` key.
"""

from __future__ import annotations

import numpy as np

from ..evals.inception import InceptionConfig
from .clip_text import CLIPTextConfig
from .clip_vision import CLIPVisionConfig
from .mmdit import MMDiTConfig
from .t5 import T5Config
from .unet import UNetConfig
from .vae import VAEConfig


def _inv_lin(node, key, sd):
    sd[f"{key}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _inv_conv(node, key, sd):
    sd[f"{key}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _inv_norm(node, key, sd, inner):
    sd[f"{key}.weight"] = np.asarray(node[inner]["scale"])
    sd[f"{key}.bias"] = np.asarray(node[inner]["bias"])


def _inv_gn(node, key, sd):
    _inv_norm(node, key, sd, "GroupNorm_0")


def _inv_ln(node, key, sd):
    _inv_norm(node, key, sd, "LayerNorm_0")


def _inv_attn(node, key, sd, names=("to_q", "to_k", "to_v", "to_out.0")):
    for src, dst in zip(("to_q", "to_k", "to_v", "to_out"), names):
        _inv_lin(node[src], f"{key}.{dst}", sd)


def _inv_resnet(node, key, sd):
    _inv_gn(node["norm1"], f"{key}.norm1", sd)
    _inv_conv(node["conv1"], f"{key}.conv1", sd)
    _inv_gn(node["norm2"], f"{key}.norm2", sd)
    _inv_conv(node["conv2"], f"{key}.conv2", sd)
    if "conv_shortcut" in node:
        _inv_conv(node["conv_shortcut"], f"{key}.conv_shortcut", sd)
    if "time_emb_proj" in node:
        _inv_lin(node["time_emb_proj"], f"{key}.time_emb_proj", sd)


def _inv_transformer2d(node, key, sd, n_layers):
    _inv_gn(node["norm"], f"{key}.norm", sd)
    _inv_conv(node["proj_in"], f"{key}.proj_in", sd)
    _inv_conv(node["proj_out"], f"{key}.proj_out", sd)
    for k in range(n_layers):
        bk = f"{key}.transformer_blocks.{k}"
        blk = node[f"blocks_{k}"]
        for ln in ("norm1", "norm2", "norm3"):
            _inv_ln(blk[ln], f"{bk}.{ln}", sd)
        _inv_attn(blk["attn1"], f"{bk}.attn1", sd)
        _inv_attn(blk["attn2"], f"{bk}.attn2", sd)
        _inv_lin(blk["ff"]["net_0"]["proj"], f"{bk}.ff.net.0.proj", sd)
        _inv_lin(blk["ff"]["net_2"], f"{bk}.ff.net.2", sd)


def _unet(params, cfg: UNetConfig) -> dict:
    sd: dict = {}
    n = len(cfg.block_out_channels)
    _inv_conv(params["conv_in"], "conv_in", sd)
    _inv_lin(params["time_emb_1"], "time_embedding.linear_1", sd)
    _inv_lin(params["time_emb_2"], "time_embedding.linear_2", sd)
    _inv_gn(params["conv_norm_out"], "conv_norm_out", sd)
    _inv_conv(params["conv_out"], "conv_out", sd)
    _inv_resnet(params["mid_resnets_0"], "mid_block.resnets.0", sd)
    _inv_resnet(params["mid_resnets_1"], "mid_block.resnets.1", sd)
    _inv_transformer2d(params["mid_attentions_0"], "mid_block.attentions.0",
                       sd, cfg.transformer_layers)
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _inv_resnet(params[f"down_{i}_resnets_{j}"],
                        f"down_blocks.{i}.resnets.{j}", sd)
            if i < n - 1:
                _inv_transformer2d(params[f"down_{i}_attentions_{j}"],
                                   f"down_blocks.{i}.attentions.{j}", sd,
                                   cfg.transformer_layers)
        if i < n - 1:
            _inv_conv(params[f"down_{i}_downsample"]["conv"],
                      f"down_blocks.{i}.downsamplers.0.conv", sd)
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _inv_resnet(params[f"up_{i}_resnets_{j}"],
                        f"up_blocks.{i}.resnets.{j}", sd)
            if i > 0:
                _inv_transformer2d(params[f"up_{i}_attentions_{j}"],
                                   f"up_blocks.{i}.attentions.{j}", sd,
                                   cfg.transformer_layers)
        if i < n - 1:
            _inv_conv(params[f"up_{i}_upsample"]["conv"],
                      f"up_blocks.{i}.upsamplers.0.conv", sd)
    return sd


def _inv_vae_mid(node, key, sd):
    _inv_resnet(node["resnets_0"], f"{key}.resnets.0", sd)
    _inv_resnet(node["resnets_1"], f"{key}.resnets.1", sd)
    _inv_gn(node["attentions_0"]["group_norm"],
            f"{key}.attentions.0.group_norm", sd)
    _inv_attn(node["attentions_0"]["attention"], f"{key}.attentions.0", sd)


def _vae(params, cfg: VAEConfig) -> dict:
    sd: dict = {}
    n = len(cfg.block_out_channels)
    for part, layers, blocks, sampler, sname in (
            ("encoder", cfg.layers_per_block, "down", "downsample",
             "downsamplers"),
            ("decoder", cfg.layers_per_block + 1, "up", "upsample",
             "upsamplers")):
        node = params[part]
        _inv_conv(node["conv_in"], f"{part}.conv_in", sd)
        _inv_vae_mid(node["mid_block"], f"{part}.mid_block", sd)
        _inv_gn(node["conv_norm_out"], f"{part}.conv_norm_out", sd)
        _inv_conv(node["conv_out"], f"{part}.conv_out", sd)
        for i in range(n):
            for j in range(layers):
                _inv_resnet(node[f"{blocks}_{i}_resnets_{j}"],
                            f"{part}.{blocks}_blocks.{i}.resnets.{j}", sd)
            if i < n - 1:
                _inv_conv(node[f"{blocks}_{i}_{sampler}"]["conv"],
                          f"{part}.{blocks}_blocks.{i}.{sname}.0.conv", sd)
    for conv in ("quant_conv", "post_quant_conv"):
        if conv in params:
            _inv_conv(params[conv], conv, sd)
    return sd


def _clip_text(params, cfg: CLIPTextConfig,
               with_projection: bool = False) -> dict:
    p = "text_model."
    sd = {
        f"{p}embeddings.token_embedding.weight":
            np.asarray(params["token_embedding"]["embedding"]),
        f"{p}embeddings.position_embedding.weight":
            np.asarray(params["position_embedding"]),
    }
    _inv_ln(params["final_layer_norm"], f"{p}final_layer_norm", sd)
    _clip_layers(params, cfg.num_layers, p, sd)
    if with_projection:
        sd["text_projection.weight"] = np.ascontiguousarray(
            np.asarray(params["text_projection"]["kernel"]).T)
    return sd


def _clip_layers(params, n: int, prefix: str, sd: dict) -> None:
    for i in range(n):
        lk = f"{prefix}encoder.layers.{i}"
        node = params[f"layers_{i}"]
        _inv_ln(node["layer_norm1"], f"{lk}.layer_norm1", sd)
        _inv_ln(node["layer_norm2"], f"{lk}.layer_norm2", sd)
        _inv_attn(node["self_attn"], f"{lk}.self_attn", sd,
                  names=("q_proj", "k_proj", "v_proj", "out_proj"))
        _inv_lin(node["mlp_fc1"], f"{lk}.mlp.fc1", sd)
        _inv_lin(node["mlp_fc2"], f"{lk}.mlp.fc2", sd)


def _clip_vision(params, cfg: CLIPVisionConfig) -> dict:
    p = "vision_model."
    sd = {f"{p}embeddings.class_embedding":
              np.asarray(params["class_embedding"]),
          f"{p}embeddings.position_embedding.weight":
              np.asarray(params["position_embedding"]),
          "visual_projection.weight": np.ascontiguousarray(
              np.asarray(params["visual_projection"]["kernel"]).T)}
    _inv_conv(params["patch_embedding"], f"{p}embeddings.patch_embedding", sd)
    _inv_ln(params["pre_layernorm"], f"{p}pre_layrnorm", sd)
    _inv_ln(params["post_layernorm"], f"{p}post_layernorm", sd)
    _clip_layers(params, cfg.num_layers, p, sd)
    return sd


def _mmdit(params, cfg: MMDiTConfig) -> dict:
    sd: dict = {}
    _inv_conv(params["pos_embed_proj"], "pos_embed.proj", sd)
    for src, dst in (("time_embed_1", "timestep_embedder.linear_1"),
                     ("time_embed_2", "timestep_embedder.linear_2"),
                     ("text_embed_1", "text_embedder.linear_1"),
                     ("text_embed_2", "text_embedder.linear_2")):
        _inv_lin(params[src], f"time_text_embed.{dst}", sd)
    _inv_lin(params["context_embedder"], "context_embedder", sd)
    _inv_lin(params["norm_out"]["linear"], "norm_out.linear", sd)
    _inv_lin(params["proj_out"], "proj_out", sd)
    names = {"attn_q": "attn.to_q", "attn_k": "attn.to_k",
             "attn_v": "attn.to_v", "attn_add_q": "attn.add_q_proj",
             "attn_add_k": "attn.add_k_proj", "attn_add_v": "attn.add_v_proj",
             "attn_to_out": "attn.to_out.0",
             "attn_to_add_out": "attn.to_add_out"}
    norms = {"attn_norm_q": "attn.norm_q", "attn_norm_k": "attn.norm_k",
             "attn_add_norm_q": "attn.norm_added_q",
             "attn_add_norm_k": "attn.norm_added_k"}
    for i in range(cfg.num_layers):
        bk = f"transformer_blocks.{i}"
        node = params[f"blocks_{i}"]
        for ln in ("norm1", "norm1_context"):
            _inv_lin(node[ln]["linear"], f"{bk}.{ln}.linear", sd)
        for src, dst in names.items():
            if src in node:
                _inv_lin(node[src], f"{bk}.{dst}", sd)
        for src, dst in norms.items():
            if src in node:
                sd[f"{bk}.{dst}.weight"] = np.asarray(node[src]["scale"])
        for ff in ("ff", "ff_context"):
            if ff in node:
                _inv_lin(node[ff]["fc1"], f"{bk}.{ff}.net.0.proj", sd)
                _inv_lin(node[ff]["fc2"], f"{bk}.{ff}.net.2", sd)
    return sd


def _t5(params, cfg: T5Config) -> dict:
    e = "encoder"
    sd = {"shared.weight": np.asarray(params["token_embedding"]["embedding"]),
          f"{e}.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              np.asarray(params["relative_attention_bias"]),
          f"{e}.final_layer_norm.weight":
              np.asarray(params["final_layer_norm"]["scale"])}
    for i in range(cfg.num_layers):
        lk = f"{e}.block.{i}.layer"
        node = params[f"blocks_{i}"]
        sd[f"{lk}.0.layer_norm.weight"] = np.asarray(node["ln_attn"]["scale"])
        sd[f"{lk}.1.layer_norm.weight"] = np.asarray(node["ln_ff"]["scale"])
        for w in ("q", "k", "v", "o"):
            _inv_lin(node["attn"][w], f"{lk}.0.SelfAttention.{w}", sd)
        for w in ("wi_0", "wi_1", "wo"):
            _inv_lin(node[w], f"{lk}.1.DenseReluDense.{w}", sd)
    return sd


def _inception(params) -> dict:
    """pt_inception names: each BasicConv2d's ``conv`` kernel and its
    ``bn_*`` leaves under ``<path>.conv`` / ``<path>.bn``, then ``fc``."""
    sd: dict = {}
    bn = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
          "bn_var": "running_var"}

    def walk(node, path):
        if "conv" in node:
            _inv_conv(node["conv"], f"{path}.conv", sd)
            for src, dst in bn.items():
                sd[f"{path}.bn.{dst}"] = np.asarray(node[src])
            return
        for name, child in node.items():
            walk(child, f"{path}.{name}" if path else name)

    walk({k: v for k, v in params.items() if k != "fc"}, "")
    _inv_lin(params["fc"], "fc", sd)
    return sd


def from_jax_params(params, cfg, with_projection: bool = False
                    ) -> dict[str, np.ndarray]:
    """JAX-package parameter tree -> the port's state dict (numpy values)
    for a UNetConfig, VAEConfig, CLIPTextConfig, CLIPVisionConfig,
    MMDiTConfig, T5Config or InceptionConfig of this package.
    ``with_projection`` keeps the CLIP text projection head."""
    if "params" in params:
        params = params["params"]
    if isinstance(cfg, UNetConfig):
        return _unet(params, cfg)
    if isinstance(cfg, VAEConfig):
        return _vae(params, cfg)
    if isinstance(cfg, CLIPTextConfig):
        return _clip_text(params, cfg, with_projection)
    if isinstance(cfg, CLIPVisionConfig):
        return _clip_vision(params, cfg)
    if isinstance(cfg, MMDiTConfig):
        return _mmdit(params, cfg)
    if isinstance(cfg, T5Config):
        return _t5(params, cfg)
    if isinstance(cfg, InceptionConfig):
        return _inception(params)
    raise TypeError(f"no bridge for {type(cfg).__name__}")
