"""Tensor parallelism over a ``model`` mesh axis (Megatron layout).

Counterpart of ``safe_denoiser_tpu/parallel/tp.py``. The rules are the JAX
package's, rewritten on the port's (diffusers) parameter names: a flax
kernel [in, out] is a torch weight [out, in], so a column-parallel layer
(JAX ``P(None, "model")``) shards torch dim 0 and a row-parallel one
(``P("model", None)``) dim 1. A parameter whose dim does not divide by the
axis stays replicated, as in JAX.

``shard_params_tp`` marks the units whose layers the rules shard -- the
UNet's ``Attention`` and GEGLU ``FeedForward``, the MMDiT's
``JointAttention`` and ``FeedForward`` -- and their forwards then run here,
one call a slot of the axis:

  * column-parallel layers (q/k/v, the MLPs' first linear) compute each
    slot's rows of the weight: attention runs per slot on its H/n heads
    (B1 at [B, S, H/n, D] on a CUDA tensor), the MLP's activation per
    slot;
  * GEGLU's projection is two halves, (h, gate): each slot takes its rows
    of each half, so h * gelu(gate) stays local (a contiguous cut of the
    projection would put h on the first slots and gate on the last);
  * row-parallel layers (the output projections, the MLPs' second linear)
    compute each slot's partial product over its columns; ``comm.psum``
    adds them (in f32) and the bias is added once.

Under int8 (``QDense`` with int8 weights) the column slots keep their rows'
per-row scales as they are, and a row-parallel layer quantizes each
activation row with the scale of its amax over the whole K (``comm.pmax``
of the slots' amaxes), sums the slots' exact integer products, then
dequantizes once: the values of the unsharded int8 layer bit for bit.

The weights are sliced at each call from the module's current parameters
(views where a slot lies on the parameter's device; a copy per call where
it does not), so ``torch.func.functional_call`` and autograd see through
the shards: a training step's gradients reach the master weights. A unit
is sharded only where all of its layers' weights are and its heads divide
over the axis; otherwise it stays replicated.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant
from . import comm
from .mesh import Mesh, module_on, on_slot

# (parameter-name regex, the sharded torch dim): 0 column-, 1 row-parallel
MMDIT_TP_RULES: list[tuple[str, int]] = [
    (r"transformer_blocks\.\d+\.attn\.(to_(q|k|v)|add_(q|k|v)_proj)\.weight$",
     0),
    (r"transformer_blocks\.\d+\.attn\.(to_(q|k|v)|add_(q|k|v)_proj)\.bias$",
     0),
    (r"transformer_blocks\.\d+\.attn\.(to_out\.0|to_add_out)\.weight$", 1),
    (r"transformer_blocks\.\d+\.ff(_context)?\.net\.0\.proj\.weight$", 0),
    (r"transformer_blocks\.\d+\.ff(_context)?\.net\.0\.proj\.bias$", 0),
    (r"transformer_blocks\.\d+\.ff(_context)?\.net\.2\.weight$", 1),
]

# SD-v1 UNet Transformer2D blocks (self/cross attention, GEGLU MLP); the
# resnet convs stay replicated (a GroupNorm sits between conv1 and conv2)
UNET_TP_RULES: list[tuple[str, int]] = [
    (r"attentions\.\d+\.transformer_blocks\.\d+\.attn\d\.to_(q|k|v)\.weight$",
     0),
    (r"attentions\.\d+\.transformer_blocks\.\d+\.attn\d\.to_out\.0\.weight$",
     1),
    (r"attentions\.\d+\.transformer_blocks\.\d+\.ff\.net\.0\.proj\.weight$",
     0),
    (r"attentions\.\d+\.transformer_blocks\.\d+\.ff\.net\.0\.proj\.bias$", 0),
    (r"attentions\.\d+\.transformer_blocks\.\d+\.ff\.net\.2\.weight$", 1),
]


def tp_layout(module: nn.Module, mesh: Mesh, rules=MMDIT_TP_RULES,
              axis: str = "model") -> dict[str, int]:
    """{parameter name: sharded dim} of the parameters the rules place on
    ``axis`` (the first matching rule; only where the dim divides)."""
    n = mesh.shape[axis]
    compiled = [(re.compile(pat), dim) for pat, dim in rules]
    out = {}
    for name, p in module.named_parameters():
        for pat, dim in compiled:
            if pat.search(name):
                if p.shape[dim] % n == 0:
                    out[name] = dim
                break
    return out


class TPShard:
    """A sharded unit's mesh and axis: its slots are ``mesh.line(axis)``
    (the model slots of the current data row)."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh = mesh
        self.axis = axis

    def devices(self) -> list:
        return self.mesh.line(self.axis)


def _units(module: nn.Module):
    """(name, unit, {layer: dim}, heads) of every unit tensor parallelism
    can take."""
    from ..models import layers, mmdit
    for name, unit in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(unit, layers.Attention):
            yield name, unit, {f"{pre}to_q": 0, f"{pre}to_k": 0,
                               f"{pre}to_v": 0, f"{pre}to_out.0": 1}, \
                unit.num_heads
        elif isinstance(unit, mmdit.JointAttention):
            want = {f"{pre}{n}": 0 for n in (
                "to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                "add_v_proj")}
            want[f"{pre}to_out.0"] = 1
            if hasattr(unit, "to_add_out"):
                want[f"{pre}to_add_out"] = 1
            yield name, unit, want, unit.cfg.num_heads
        elif isinstance(unit, (layers.FeedForward, mmdit.FeedForward)):
            halves = 2 if isinstance(unit, layers.FeedForward) else 1
            yield name, unit, {f"{pre}net.0.proj": 0, f"{pre}net.2": 1}, \
                unit.net[2].in_features // halves


def shard_params_tp(module: nn.Module, mesh: Mesh, rules=MMDIT_TP_RULES,
                    axis: str = "model") -> nn.Module:
    """Shard ``module``'s units per the rules over ``axis`` (in place: each
    unit whose weights the rules shard, all of them, runs tensor-parallel
    from now on); returns the module. Unmatched units stay replicated."""
    layout = tp_layout(module, mesh, rules, axis)
    n = mesh.shape[axis]
    for _, unit, want, heads in _units(module):
        ok = heads % n == 0 and all(
            layout.get(f"{layer}.weight") == dim
            for layer, dim in want.items())
        unit._tp = TPShard(mesh, axis) if ok else None
    return module


def clear_tp(module: nn.Module) -> None:
    """Every unit of ``module`` back to its replicated forward."""
    for _, unit, _, _ in _units(module):
        unit._tp = None


# ----------------------------------------------------------------- layers
def column(layer: nn.Linear, x: torch.Tensor, start: int, length: int,
           dev) -> torch.Tensor:
    """Rows [start, start+length) of ``layer``'s output, on ``dev``."""
    w = layer.weight.narrow(0, start, length).to(dev)
    b = None if layer.bias is None else \
        layer.bias.narrow(0, start, length).to(dev)
    x = x.to(dev)
    if w.dtype == torch.int8:
        sw = layer.weight_scale.narrow(0, start, length).to(dev)
        return quant.int8_dense(x, w, sw, b, x.dtype)
    return F.linear(x, w, b)


def row(layer: nn.Linear, hs: list, devs: list, home) -> torch.Tensor:
    """``layer`` applied to the concatenation of the slots' column blocks
    ``hs`` (slot s holds columns [s*k, (s+1)*k) of its input): the slots'
    partial products summed across the axis, the bias added once; on
    ``home``."""
    k = hs[0].shape[-1]
    dtype = hs[0].dtype
    ws = [layer.weight.narrow(1, s * k, k).to(d) for s, d in enumerate(devs)]
    bias = None if layer.bias is None else layer.bias.to(home).float()
    if ws[0].dtype == torch.int8:
        x32 = [h.float() for h in hs]
        amax = comm.pmax([x.abs().amax(-1, keepdim=True) for x in x32], devs)
        parts = []
        for x, a, w, d in zip(x32, amax, ws, devs):
            with on_slot(d):
                sx = torch.clamp(a, min=1e-12) / 127.0
                xq = quant.quantize_rows(x, sx)
                parts.append(quant.int8_products(
                    xq.reshape(-1, k), w.contiguous()))
        y = comm.psum(parts, devs)[0].to(home).float()
        sx = torch.clamp(amax[0].to(home), min=1e-12) / 127.0
        y = y.reshape(*hs[0].shape[:-1], -1) * sx \
            * layer.weight_scale.to(home).float()
    else:
        parts = []
        for h, w, d in zip(hs, ws, devs):
            with on_slot(d):
                parts.append(F.linear(h, w).float())
        y = comm.psum(parts, devs)[0].to(home)
    if bias is not None:
        y = y + bias
    return y.to(dtype)


# ------------------------------------------------------------------ units
def attention(attn, x: torch.Tensor, context=None, mask=None):
    """The UNet's ``layers.Attention`` over the model slots."""
    from ..models.layers import dot_product_attention
    devs = attn._tp.devices()
    context = x if context is None else context
    heads = attn.num_heads // len(devs)
    width = heads * attn.head_dim
    b, s, _ = x.shape
    outs = []
    for i, dev in enumerate(devs):
        st = i * width
        with on_slot(dev):
            q = column(attn.to_q, x, st, width, dev).view(b, s, heads, -1)
            k = column(attn.to_k, context, st, width, dev).view(
                b, context.shape[1], heads, -1)
            v = column(attn.to_v, context, st, width, dev).view(
                b, context.shape[1], heads, -1)
            o = dot_product_attention(q, k, v, None if mask is None
                                      else mask.to(dev))
        outs.append(o.reshape(b, s, width))
    return row(attn.to_out[0], outs, devs, x.device)


def feed_forward(ff, x: torch.Tensor) -> torch.Tensor:
    """A ``layers.FeedForward`` (GEGLU) or ``mmdit.FeedForward`` (tanh
    GELU) over the model slots."""
    from ..models.layers import GEGLU, gelu_for
    devs = ff._tp.devices()
    n = len(devs)
    hs = []
    if isinstance(ff.net[0], GEGLU):
        proj = ff.net[0].proj
        inner = proj.out_features // 2
        c = inner // n
        for i, dev in enumerate(devs):
            # one [..., 2c] tensor cut in two, as GEGLU cuts its own: the
            # activation sees the layout it sees unsharded (the CPU's
            # pointwise kernels round by layout)
            with on_slot(dev):
                h, gate = torch.cat([column(proj, x, i * c, c, dev),
                                     column(proj, x, inner + i * c, c, dev)],
                                    -1).chunk(2, -1)
                hs.append(h * gelu_for(x.dtype)(gate))
    else:
        proj = ff.net[0].proj
        c = proj.out_features // n
        for i, dev in enumerate(devs):
            with on_slot(dev):
                hs.append(F.gelu(column(proj, x, i * c, c, dev),
                                 approximate="tanh"))
    return row(ff.net[2], hs, devs, x.device)


def joint_attention(attn, xh: torch.Tensor, ch: torch.Tensor):
    """The MMDiT's ``JointAttention`` with its output projections over the
    model slots: (to_out(image part), to_add_out(context part) or None for
    a context_pre_only block)."""
    from ..models.layers import dot_product_attention
    devs = attn._tp.devices()
    cfg = attn.cfg
    heads = cfg.num_heads // len(devs)
    width = heads * cfg.head_dim
    rms = cfg.qk_norm == "rms_norm"
    s_img = xh.shape[1]
    x_outs, c_outs = [], []
    for i, dev in enumerate(devs):
        st = i * width

        def qkv(h, names, norms):
            b, s, _ = h.shape
            q, k, v = (column(getattr(attn, n), h, st, width, dev).view(
                b, s, heads, cfg.head_dim) for n in names)
            if rms:
                q = module_on(getattr(attn, norms[0]), dev)(q)
                k = module_on(getattr(attn, norms[1]), dev)(k)
            return q, k, v

        with on_slot(dev):
            xq, xk, xv = qkv(xh, ("to_q", "to_k", "to_v"),
                             ("norm_q", "norm_k"))
            cq, ck, cv = qkv(ch, ("add_q_proj", "add_k_proj", "add_v_proj"),
                             ("norm_added_q", "norm_added_k"))
            out = dot_product_attention(torch.cat([xq, cq], 1),
                                        torch.cat([xk, ck], 1),
                                        torch.cat([xv, cv], 1))
        out = out.reshape(out.shape[0], out.shape[1], width)
        x_outs.append(out[:, :s_img])
        c_outs.append(out[:, s_img:])
    x_att = row(attn.to_out[0], x_outs, devs, xh.device)
    c_att = (row(attn.to_add_out, c_outs, devs, xh.device)
             if hasattr(attn, "to_add_out") else None)
    return x_att, c_att
