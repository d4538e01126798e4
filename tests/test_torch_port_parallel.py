"""The port's parallel layer (``safe_denoiser_tpu_torch/parallel/``) against
the JAX package's on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's on meshes of CPU slots (``make_mesh(devices=[cpu] *
n)``), each slot a call of the ordinary code. Inputs come from numpy
seeds; weights are JAX trees carried into the port by ``from_jax_params``.
Tolerances are f32: 1e-5 where only the order of f32 sums differs, 1e-4
through a model, bit for bit where the math is exact (int8, zero blocks,
pad rows).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from safe_denoiser_tpu import parallel as jpar
from safe_denoiser_tpu.models import mmdit as j_mmdit
from safe_denoiser_tpu.models import unet as j_unet
from safe_denoiser_tpu.repellency import methods as j_methods
from safe_denoiser_tpu_torch import parallel as tpar
from safe_denoiser_tpu_torch.models import mmdit as t_mmdit
from safe_denoiser_tpu_torch.models import unet as t_unet
from safe_denoiser_tpu_torch.models.weights_export import flax_linear_paths
from safe_denoiser_tpu_torch.ops import quant
from safe_denoiser_tpu_torch.ops.repellency_kernels import (
    rbf_negative_score, sparse_repellency_force)
from safe_denoiser_tpu_torch.parallel import comm
from safe_denoiser_tpu_torch.repellency import methods as t_methods
from tests.test_torch_port_models import load, random_params
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
MMDIT_KW = dict(sample_size=8, num_layers=3, num_heads=4, head_dim=8,
                joint_attention_dim=48, caption_projection_dim=32,
                pooled_projection_dim=40, pos_embed_max_size=16)
# 4 heads; GEGLU's 4x inner width leaves each of 4 model slots 32 columns
# of h and of gate (the CPU's erf rounds rows shorter than 32 floats by
# another path, which would break the bit-for-bit int8 check)
UNET_KW = dict(sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
               cross_attention_dim=16, num_attention_heads=4,
               norm_num_groups=8)


def slots(n):
    return [CPU] * n


def jmesh(shape, names):
    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def tmesh(shape, names):
    n = int(np.prod(shape))
    return tpar.Mesh(np.asarray(slots(n), dtype=object).reshape(shape),
                     names)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ------------------------------------------------------------------ mesh
def test_make_mesh_needs_as_many_gpus(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="2 are visible"):
        tpar.make_mesh(4)
    mesh = tpar.make_mesh()
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="0 are visible"):
        tpar.make_mesh()
    # an explicit list may repeat a device
    assert tpar.make_mesh(devices=["cuda:0"] * 8).devices.size == 8


@pytest.mark.parametrize("shape,names", [((4,), ("data",)),
                                         ((2, 4), ("data", "model")),
                                         ((2, 2), ("data", "seq"))])
def test_mesh_shape_and_shard_batch_match_jax(shape, names):
    jm, tm = jmesh(shape, names), tmesh(shape, names)
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.devices.shape == jm.devices.shape
    x = np.random.RandomState(0).randn(8, 3, 5).astype(np.float32)
    for dim in (0, 1) if shape[0] == 4 else (0,):
        xx = np.moveaxis(x, 0, dim).copy()
        want = jpar.shard_batch(jnp.asarray(xx), jm, batch_dim=dim)
        got = tpar.shard_batch(t(xx), tm, batch_dim=dim)
        by_dev = {s.device: np.asarray(s.data)
                  for s in want.addressable_shards}
        for i, piece in enumerate(got):
            idx = (i,) + (0,) * (len(shape) - 1)
            np.testing.assert_array_equal(piece.numpy(),
                                          by_dev[jm.devices[idx]])


def test_replicate_makes_one_copy_per_distinct_device():
    lin = torch.nn.Linear(3, 4)
    mesh = tpar.Mesh([CPU, torch.device("meta"), CPU, torch.device("meta")],
                     ("data",))
    out = tpar.replicate(lin, mesh)
    assert out[0] is lin and out[2] is lin
    assert out[1] is out[3] and out[1] is not lin
    assert out[1].weight.device.type == "meta"
    tree = tpar.replicate({"w": lin.weight.detach()}, mesh)
    assert tree[0]["w"] is tree[2]["w"] and tree[1]["w"] is tree[3]["w"]


def test_module_on_makes_its_copy_again_when_the_weights_change():
    """One copy per (module, device), kept while the module is unchanged,
    made again after an in-place weight change or a layer swap, and gone
    with its module."""
    import gc

    from safe_denoiser_tpu_torch.parallel import mesh as tmesh_mod
    meta = torch.device("meta")
    seq = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    assert tmesh_mod.module_on(seq, CPU) is seq
    first = tmesh_mod.module_on(seq, meta)
    assert first is not seq and first[0].weight.is_meta
    assert tmesh_mod.module_on(seq, meta) is first
    with torch.no_grad():
        seq[0].weight.add_(1.0)
    second = tmesh_mod.module_on(seq, meta)
    assert second is not first
    seq[1] = torch.nn.Linear(4, 2, bias=False)
    third = tmesh_mod.module_on(seq, meta)
    assert third is not second and third[1].bias is None
    assert tmesh_mod.module_on(seq, meta) is third
    held = len(tmesh_mod._REPLICAS)
    del seq
    gc.collect()
    assert len(tmesh_mod._REPLICAS) == held - 1


def test_slot_work_runs_with_its_device_current(monkeypatch):
    """``on_slot`` makes a CUDA slot's device current (nothing for the
    CPU), and a kernel wrapper refuses a tensor of a device that is not
    current: the GPU's current device stands in here."""
    from safe_denoiser_tpu_torch.ops import _build
    from safe_denoiser_tpu_torch.parallel.mesh import on_slot
    assert isinstance(on_slot(torch.device("cuda", 1)), torch.cuda.device)
    with on_slot(CPU):
        pass
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    _build.require_current(torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="cuda:1 while cuda:0"):
        _build.require_current(torch.device("cuda", 1))


def test_comm_reduces_in_slot_order():
    rs = np.random.RandomState(1)
    parts = [t(rs.randn(3, 4).astype(np.float32)) for _ in range(4)]
    got = comm.psum(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(torch.equal(g, want) for g in got)
    assert torch.equal(comm.pmax(parts)[1],
                       torch.stack(parts).amax(0))
    assert torch.equal(comm.all_gather(parts, 1)[3], torch.cat(parts, 1))
    moved = comm.ppermute(parts, [(0, 1), (1, 2)], slots(4))
    assert moved[0] is None and moved[3] is None
    assert torch.equal(moved[2], parts[1])


# ------------------------------------------------------------------ bank
def _bank(m=13, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(4, 256).astype(np.float32)
    refs = (x[rs.randint(0, 4, m)] + 0.8 * rs.randn(m, 256)).astype(
        np.float32)
    return x, refs


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_score_and_force_match_jax(n):
    x, refs = _bank()
    jm = jmesh((n,), ("data",))
    tm = tpar.make_mesh(devices=slots(n))
    shards = tpar.shard_bank(t(refs), tm)
    assert sum(s.shape[0] for s in shards) == -(-13 // n) * n
    j_sh = jpar.shard_bank(jnp.asarray(refs), jm)
    for sigma in (20.0, 30.0):
        want = jax.jit(lambda a, r: jpar.sharded_negative_score(
            a, r, sigma, mesh=jm))(jnp.asarray(x), j_sh)
        got = tpar.sharded_negative_score(t(x), shards, sigma, mesh=tm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
    want = jax.jit(lambda a, r: jpar.sharded_sparse_force(
        a, r, 24.0, mesh=jm))(jnp.asarray(x), j_sh)
    got = tpar.sharded_sparse_force(t(x), shards, 24.0, mesh=tm)
    assert float(got[1].min()) > 0           # the force acts on every row
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_pad_rows_contribute_exactly_zero():
    x, refs = _bank()
    pad = torch.full((3, 256), tpar.PAD_VALUE)
    num, beta = rbf_negative_score(t(x), pad, 20.0, normalize=False)
    assert torch.equal(num, torch.zeros_like(num))
    assert torch.equal(beta, torch.zeros_like(beta))
    cr, c_sum = sparse_repellency_force(t(x), pad, 24.0, raw=True)
    assert not cr.any() and not c_sum.any()
    # a whole bank, padded to 16 over 8 slots, against the unpadded sum
    tm = tpar.make_mesh(devices=slots(8))
    num_s, beta_s = tpar.sharded_negative_score(t(x), t(refs), 20.0,
                                                mesh=tm, epsilon=0.0)
    num_r, beta_r = rbf_negative_score(t(x), t(refs), 20.0, epsilon=0.0)
    np.testing.assert_allclose(beta_s.numpy(), beta_r.numpy(), rtol=1e-6)


@pytest.mark.parametrize("method", ["kernel_fast", "sparse"])
def test_apply_repellency_with_a_sharded_bank_matches_jax(method):
    rs = np.random.RandomState(3)
    x0 = rs.randn(4, 4, 8, 8).astype(np.float32)
    refs = (x0[rs.randint(0, 4, 13)] + 0.5 * rs.randn(13, 4, 8, 8)).astype(
        np.float32)
    kw = (dict(sigma=4.0, scale=0.3, beta_threshold=1e-6)
          if method == "kernel_fast" else dict(radius=24.0, scale=1e-3))
    jm = jmesh((2, 2), ("data", "model"))
    tm = tmesh((2, 2), ("data", "model"))
    j_bank = jpar.ShardedBank(jm, axis="model", batch_axis="data")
    t_bank = tpar.ShardedBank(tm, axis="model", batch_axis="data")
    want = j_methods.apply_repellency(
        jnp.asarray(x0), jpar.shard_bank(jnp.asarray(refs), jm, "model"),
        j_methods.RepellencyConfig(method=method, **kw), bank=j_bank)
    got = t_methods.apply_repellency(
        t(x0), tpar.shard_bank(t(refs), tm, "model"),
        t_methods.RepellencyConfig(method=method, **kw), bank=t_bank)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- models
_MODELS: dict = {}


def mmdit_pair(num_layers=3):
    key = ("mmdit", num_layers)
    if key not in _MODELS:
        cfg = j_mmdit.MMDiTConfig(**{**MMDIT_KW, "num_layers": num_layers})
        model = j_mmdit.MMDiT(cfg)
        params = random_params(model, 21, jax.random.PRNGKey(0),
                               jnp.zeros((1, 8, 8, 16)), jnp.zeros((1,)),
                               jnp.zeros((1, 12, 48)), jnp.zeros((1, 40)))
        tcfg = t_mmdit.MMDiTConfig(**{**MMDIT_KW, "num_layers": num_layers})
        _MODELS[key] = (cfg, model, params,
                        load(t_mmdit.MMDiT(tcfg), params, tcfg))
    return _MODELS[key]


def unet_pair():
    if "unet" not in _MODELS:
        model = j_unet.UNet2DCondition(j_unet.UNetConfig(**UNET_KW))
        params = random_params(model, 22, jax.random.PRNGKey(0),
                               jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                               jnp.zeros((1, 7, 16)))
        tcfg = t_unet.UNetConfig(**UNET_KW)
        _MODELS["unet"] = (model, params,
                           load(t_unet.UNet2DConditionModel(tcfg), params,
                                tcfg))
    return _MODELS["unet"]


def mmdit_inputs(b=2, seed=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 8, 8, 16).astype(np.float32)
    return (x, np.full((b,), 500.0, np.float32),
            rs.randn(b, 12, 48).astype(np.float32),
            rs.randn(b, 40).astype(np.float32))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _port_mmdit(x, ts, ctx, pooled, model, **kw):
    with torch.no_grad():
        return model(t(x.transpose(0, 3, 1, 2)), t(ts), t(ctx), t(pooled),
                     **kw).numpy()


def test_sp_joint_attention_matches_jax():
    from safe_denoiser_tpu.models.layers import dot_product_attention as jdpa
    rs = np.random.RandomState(5)
    b, s_img, s_ctx, h, d = 2, 16, 5, 4, 8
    xq, xk, xv = (rs.randn(b, s_img, h, d).astype(np.float32)
                  for _ in range(3))
    cq, ck, cv = (rs.randn(b, s_ctx, h, d).astype(np.float32)
                  for _ in range(3))
    jm = jmesh((1, 4), ("data", "seq"))
    want = jax.jit(lambda *a: jpar.sp_joint_attention(*a, mesh=jm))(
        *map(jnp.asarray, (xq, xk, xv, cq, ck, cv)))
    tm = tpar.make_mesh(devices=slots(4), axis="seq")
    img, ctx = tpar.sp_joint_attention(*map(t, (xq, xk, xv, cq, ck, cv)),
                                       tm)
    assert [p.shape[1] for p in img] == [4] * 4
    np.testing.assert_allclose(torch.cat(img, 1).numpy(),
                               np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    for c in ctx:                       # the same on every slot
        np.testing.assert_array_equal(c.numpy(), ctx[0].numpy())
    np.testing.assert_allclose(ctx[0].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)
    q = jnp.concatenate([xq, cq], 1)
    full = jdpa(q, jnp.concatenate([xk, ck], 1), jnp.concatenate([xv, cv], 1))
    np.testing.assert_allclose(ctx[0].numpy(), np.asarray(full[:, s_img:]),
                               rtol=1e-5, atol=1e-6)


def test_mmdit_sp_matches_jax():
    cfg, model, params, tf = mmdit_pair()
    x, ts, ctx, pooled = mmdit_inputs()
    jm = jmesh((2, 4), ("data", "seq"))
    want = jax.jit(j_mmdit.MMDiT(cfg, sp_mesh=jm).apply)(
        params, x, ts, ctx, pooled)
    tf_sp = copy.deepcopy(tf)
    tf_sp.sp_mesh = tmesh((2, 4), ("data", "seq"))
    got = _port_mmdit(x, ts, ctx, pooled, tf_sp)
    np.testing.assert_allclose(got, _nchw(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _port_mmdit(x, ts, ctx, pooled, tf),
                               rtol=1e-5, atol=1e-5)


def test_zero_joint_block_is_an_exact_identity():
    _, _, _, tf = mmdit_pair()
    zero = tpar.stack_block_params(tf, 3, 4)[-1]
    assert zero is not tf.transformer_blocks[0]
    assert all(not p.any() for p in zero.parameters())
    rs = np.random.RandomState(6)
    x, c, e = (t(rs.randn(*s).astype(np.float32))
               for s in ((2, 16, 32), (2, 12, 32), (2, 32)))
    with torch.no_grad():
        xo, co = zero(x, c, e)
    assert torch.equal(xo, x) and torch.equal(co, c)


def test_pp_blocks_match_jax():
    """4 stages, 2 microbatches: blocks 0..1 of the 3-block model and two
    zero blocks."""
    cfg, _, params, tf = mmdit_pair()
    rs = np.random.RandomState(7)
    x, c, e = (rs.randn(*s).astype(np.float32)
               for s in ((4, 16, 32), (4, 12, 32), (4, 32)))
    jm = jmesh((4,), ("pipe",))
    stacked = jpar.shard_stacked_pp(jpar.stack_block_params(params, 3, 4), jm)
    want = jax.jit(lambda s, *a: jpar.pp_blocks(cfg, s, *a, jm, n_micro=2))(
        stacked, x, c, e)
    tm = tpar.make_mesh(devices=slots(4), axis="pipe")
    st = tpar.shard_stacked_pp(tpar.stack_block_params(tf, 3, 4), tm)
    assert [len(s) for s in st] == [1, 1, 1, 1]
    with torch.no_grad():
        got = tpar.pp_blocks(None, st, t(x), t(c), t(e), tm, n_micro=2)
        seq_x, seq_c = t(x), t(c)
        for blk in tf.transformer_blocks[:2]:
            seq_x, seq_c = blk(seq_x, seq_c, t(e))
    for g, w, s in zip(got, want, (seq_x, seq_c)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(g, s)      # the blocks in order, per microbatch


def test_mmdit_pp_matches_jax():
    cfg, _, params, tf = mmdit_pair()
    x, ts, ctx, pooled = (np.concatenate([a, a]) for a in mmdit_inputs())
    jm = jmesh((2, 2), ("data", "pipe"))
    stacked = jpar.shard_stacked_pp(jpar.stack_block_params(params, 3, 2), jm)
    want = jax.jit(lambda v, s, *a: j_mmdit.MMDiT(cfg, pp_mesh=jm).apply(
        v, *a, pp_params=s))(params, stacked, x, ts, ctx, pooled)
    tm = tmesh((2, 2), ("data", "pipe"))
    tf_pp = copy.deepcopy(tf)
    tf_pp.pp_mesh = tm
    st = tpar.shard_stacked_pp(tpar.stack_block_params(tf_pp, 3, 2), tm)
    got = _port_mmdit(x, ts, ctx, pooled, tf_pp, pp_params=st)
    np.testing.assert_allclose(got, _nchw(want), rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------------- tp
def _jax_layout(placed, names: dict) -> dict:
    """{port name: sharded torch dim} of the JAX leaves the rules placed
    on 'model' (a kernel's dim transposed)."""
    out = {}
    for port_w, path in names.items():
        node = placed
        for k in path.split("/")[:-1]:
            node = node[k]
        for leaf, port in (("kernel", port_w),
                           ("bias", port_w[:-len("weight")] + "bias")):
            if leaf not in node:
                continue
            spec = tuple(node[leaf].sharding.spec)
            if "model" in spec:
                j = spec.index("model")
                out[port] = (1 - j) if leaf == "kernel" else 0
    return out


@pytest.mark.parametrize("which,n", [("mmdit", 2), ("mmdit", 4),
                                     ("unet", 2), ("unet", 4)])
def test_tp_rules_select_what_jax_selects(which, n):
    jm, tm = jmesh((1, n), ("data", "model")), tmesh((1, n),
                                                     ("data", "model"))
    if which == "mmdit":
        cfg, _, params, module = mmdit_pair()
        rules = (jpar.MMDIT_TP_RULES, tpar.MMDIT_TP_RULES)
        tcfg = module.config
    else:
        _, params, module = unet_pair()
        rules = (jpar.UNET_TP_RULES, tpar.UNET_TP_RULES)
        tcfg = module.config
    placed = jpar.shard_params_tp(params, jm, rules=rules[0])
    names = flax_linear_paths(tcfg, dict(module.named_parameters()))
    want = _jax_layout(placed, names)
    assert want and tpar.tp_layout(module, tm, rules[1]) == want


@pytest.mark.parametrize("n", [2, 4])
def test_mmdit_tp_forward_matches_jax(n):
    cfg, model, params, tf = mmdit_pair()
    x, ts, ctx, pooled = mmdit_inputs()
    jm = jmesh((1, n), ("data", "model"))
    want = jax.jit(model.apply)(jpar.shard_params_tp(params, jm), x, ts,
                                ctx, pooled)
    tf_tp = tpar.shard_params_tp(copy.deepcopy(tf), tmesh((1, n), (
        "data", "model")))
    assert tf_tp.transformer_blocks[0].attn._tp is not None
    assert tf_tp.transformer_blocks[2].ff._tp is not None
    got = _port_mmdit(x, ts, ctx, pooled, tf_tp)
    np.testing.assert_allclose(got, _nchw(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_unet_tp_forward_with_geglu_matches_jax(n):
    """GEGLU's projection sharded half by half: each slot holds its rows of
    h and of gate."""
    model, params, unet = unet_pair()
    rs = np.random.RandomState(8)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 7, 16).astype(np.float32)
    jm = jmesh((2, n), ("data", "model"))
    want = jax.jit(model.apply)(
        jpar.shard_params_tp(params, jm, rules=jpar.UNET_TP_RULES), x, 500,
        ctx)
    u_tp = tpar.shard_params_tp(copy.deepcopy(unet),
                                tmesh((2, n), ("data", "model")),
                                rules=tpar.UNET_TP_RULES)
    ff = u_tp.down_blocks[0].attentions[0].transformer_blocks[0].ff
    assert ff._tp is not None and ff._tp.devices() == slots(n)
    with torch.no_grad():
        got = u_tp(t(_nchw(x)), 500, t(ctx)).numpy()
        plain = unet(t(_nchw(x)), 500, t(ctx)).numpy()
    np.testing.assert_allclose(got, _nchw(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


def test_tp_leaves_a_unit_whose_heads_do_not_divide():
    _, _, _, tf = mmdit_pair()
    tf3 = tpar.shard_params_tp(copy.deepcopy(tf), tmesh((1, 8),
                                                        ("data", "model")))
    assert tf3.transformer_blocks[0].attn._tp is None   # 4 heads over 8


@pytest.mark.parametrize("which", ["mmdit", "unet"])
def test_int8_tp_forward_is_the_unsharded_int8_bit_for_bit(which):
    """Column slots keep their rows' scales, row slots quantize with the
    pmax'd amax of the whole K and sum exact integer products."""
    if which == "mmdit":
        base = copy.deepcopy(mmdit_pair()[3])
        quant.load_quantized(base, *quant.quantize_mmdit_params(
            base.state_dict()))
        x, ts, ctx, pooled = mmdit_inputs()
        args = (t(x.transpose(0, 3, 1, 2)), t(ts), t(ctx), t(pooled))
        rules = tpar.MMDIT_TP_RULES
    else:
        base = copy.deepcopy(unet_pair()[2])
        quant.load_quantized(base, *quant.quantize_unet_params(
            base.state_dict(), min_dim=16))
        rs = np.random.RandomState(9)
        args = (t(rs.randn(2, 4, 8, 8).astype(np.float32)), 500,
                t(rs.randn(2, 7, 16).astype(np.float32)))
        rules = tpar.UNET_TP_RULES
    with torch.no_grad():
        want = base(*args)
        for n in (2, 4):
            sharded = tpar.shard_params_tp(
                copy.deepcopy(base), tmesh((1, n), ("data", "model")), rules)
            assert torch.equal(sharded(*args), want)


def test_tp_row_int8_matches_int8_dense_bit_for_bit():
    rs = np.random.RandomState(10)
    layer = torch.nn.Linear(64, 24)
    wq, sw = quant.quantize_dense_kernel(layer.weight.detach())
    from safe_denoiser_tpu_torch.models.layers import QDense
    q = QDense(64, 24)
    q.load_state_dict(layer.state_dict())
    q.set_int8(wq, sw)
    h = t(rs.randn(3, 5, 64).astype(np.float32) * 3)
    want = quant.int8_dense(h, wq, sw, q.bias, torch.float32)
    got = tpar.tp.row(q, list(h.chunk(4, -1)), slots(4), CPU)
    assert torch.equal(got, want)


# ---------------------------------------------------------------- dryrun
def test_dryrun_multichip_on_cpu_slots():
    from safe_denoiser_tpu_torch.dryrun import dryrun_multichip
    lines = []
    dryrun_multichip(devices=["cpu"] * 4, say=lines.append)
    assert len(lines) == 16 and all(": OK" in ln for ln in lines), lines
    names = [ln.split(":")[0].split()[-1] for ln in lines]
    assert names[:3] == ["dryrun_multichip(4)", "dp-vs-local(4)",
                         "activating(4)"]
    assert names[-1] == "serve-mesh(4)"


def test_mesh_gpus_check_imports_nothing_forbidden():
    """``mesh_gpus_check.py`` runs on a GPU machine without JAX: it imports
    none of the packages the port may not import."""
    import ast
    import os

    from tests.test_torch_port_pipeline import FORBIDDEN, ROOT
    path = os.path.join(ROOT, "mesh_gpus_check.py")
    mods = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    assert "chip_smoke" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]
