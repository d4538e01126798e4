"""The port's serving slice on the CPU: the batcher and the HTTP server
(the JAX package's tests/test_serving.py cases against the port's copies),
``runners.serve``'s flags and the deployment bundle's meta against the JAX
package's, every refusal of the JAX package's serving and bundle tests,
and serving end to end on tiny checkpoints: the server's images equal
``generate_batch``'s bit for bit, two-phase equals synchronous, and a
bundle (statics in a file, graphs captured at its first generate on the
card) equals the live pipeline for 'none', SLD, SAFREE and SD3.

The JAX package's meta comes from its ``export_pipeline`` with
``jax.export.export`` stubbed: the meta does not depend on the exported
programs, and exporting them compiles the whole scan.
"""

import base64
import http.client
import io
import json
import threading
import time
import zipfile
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from safe_denoiser_tpu.runners import serve as j_serve
from safe_denoiser_tpu.serving import aot as j_aot
from safe_denoiser_tpu_torch.data.images import decode_png
from safe_denoiser_tpu_torch.pipeline.diffusion import ERASE_SPECS
from safe_denoiser_tpu_torch.repellency import RepellencyConfig
from safe_denoiser_tpu_torch.runners import serve as t_serve
from safe_denoiser_tpu_torch.serving import (DynamicBatcher, GenRequest,
                                             make_server)
from safe_denoiser_tpu_torch.serving import aot as t_aot
from safe_denoiser_tpu_torch.utils.logging import Logger
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401


# ----------------------------------------------------------------- batcher
def test_batcher_groups_full_batches():
    groups = []

    def run(reqs):
        groups.append(list(reqs))
        return [r.seed for r in reqs]

    b = DynamicBatcher(run, batch_size=4, max_delay_s=5.0)
    futs = [b.submit(GenRequest("p", seed=i)) for i in range(8)]
    results = [f.result(timeout=10) for f in futs]
    b.close()
    assert results == list(range(8))
    assert [len(g) for g in groups] == [4, 4]
    assert all(len({id(r) for r in g}) == 4 for g in groups)  # no pads


def test_batcher_pads_partial_batch_after_deadline():
    groups = []

    def run(reqs):
        groups.append(list(reqs))
        return [r.seed for r in reqs]

    b = DynamicBatcher(run, batch_size=4, max_delay_s=0.05)
    t0 = time.monotonic()
    fut = b.submit(GenRequest("solo", seed=99))
    assert fut.result(timeout=10) == 99
    assert time.monotonic() - t0 < 5.0
    b.close()
    (g,) = groups
    assert len(g) == 4 and all(r.seed == 99 for r in g)


def test_batcher_error_isolated_to_its_batch():
    calls = {"n": 0}

    def run(reqs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return [r.seed for r in reqs]

    b = DynamicBatcher(run, batch_size=2, max_delay_s=0.02)
    f1 = b.submit(GenRequest("a", seed=1))
    f2 = b.submit(GenRequest("b", seed=2))
    with pytest.raises(RuntimeError, match="boom"):
        f1.result(timeout=10)
    with pytest.raises(RuntimeError):
        f2.result(timeout=10)
    assert b.submit(GenRequest("c", seed=3)).result(timeout=10) == 3
    b.close()


@pytest.mark.parametrize("drain", [True, False])
def test_batcher_close_drains_or_fails_the_queue(drain):
    release = threading.Event()

    def run(reqs):
        release.wait(timeout=10)
        return [r.seed for r in reqs]

    b = DynamicBatcher(run, batch_size=2, max_delay_s=0.01)
    futs = [b.submit(GenRequest("p", seed=i)) for i in range(5)]
    release.set()
    b.close(drain=drain)
    if drain:
        assert [f.result(timeout=10) for f in futs] == list(range(5))
    else:
        for f in futs:
            assert f.done()
            if f.exception() is not None:
                assert "closed" in str(f.exception())


def test_batcher_rejects_after_close():
    b = DynamicBatcher(lambda reqs: [0] * len(reqs), 1)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(GenRequest("p"))


class _TwoPhaseStub:
    """A two-phase generate fn recording dispatch/fetch order."""

    def __init__(self, events, fail_dispatch_on=None, fail_fetch_on=None,
                 gate=None):
        self.events, self.n, self.gate = events, 0, gate
        self.fail_dispatch_on, self.fail_fetch_on = (fail_dispatch_on,
                                                     fail_fetch_on)

    def dispatch(self, reqs):
        k, self.n = self.n, self.n + 1
        self.events.append(f"dispatch{k}")
        if k == self.fail_dispatch_on:
            raise RuntimeError(f"dispatch boom {k}")
        stub = self

        class _H:
            def fetch(self):
                if k == 0 and stub.gate is not None:
                    assert stub.gate.wait(timeout=10)
                stub.events.append(f"fetch{k}")
                if k == stub.fail_fetch_on:
                    raise RuntimeError(f"fetch boom {k}")
                return [r.seed for r in reqs]
        return _H()


def test_batcher_two_phase_dispatches_before_fetch():
    """Batch 1 is dispatched while batch 0's fetch is blocked; results
    still reach the right futures."""
    events, gate = [], threading.Event()
    b = DynamicBatcher(lambda reqs: [r.seed for r in reqs], batch_size=2,
                       max_delay_s=0.05,
                       dispatch_batch=_TwoPhaseStub(events, gate=gate).dispatch)
    futs = [b.submit(GenRequest("p", seed=i)) for i in range(4)]
    deadline = time.monotonic() + 5
    while "dispatch1" not in events and time.monotonic() < deadline:
        time.sleep(0.01)
    assert "dispatch1" in events and "fetch0" not in events, events
    gate.set()
    assert [f.result(timeout=10) for f in futs] == list(range(4))
    b.close()
    assert events.count("fetch0") == 1 and events.count("fetch1") == 1


def test_batcher_two_phase_lone_request_resolves():
    events = []
    b = DynamicBatcher(lambda reqs: [r.seed for r in reqs], batch_size=2,
                       max_delay_s=0.02,
                       dispatch_batch=_TwoPhaseStub(events).dispatch)
    assert b.submit(GenRequest("solo", seed=9)).result(timeout=10) == 9
    b.close()
    assert events == ["dispatch0", "fetch0"]


@pytest.mark.parametrize("where", ["dispatch", "fetch"])
def test_batcher_two_phase_errors_isolated(where):
    events = []
    stub = _TwoPhaseStub(events, **{f"fail_{where}_on": 0})
    b = DynamicBatcher(lambda reqs: [r.seed for r in reqs], batch_size=1,
                       max_delay_s=0.01, dispatch_batch=stub.dispatch)
    with pytest.raises(RuntimeError, match=f"{where} boom 0"):
        b.submit(GenRequest("a", seed=1)).result(timeout=10)
    assert b.submit(GenRequest("b", seed=2)).result(timeout=10) == 2
    b.close()


def test_batcher_cancelled_future_does_not_kill_worker():
    release = threading.Event()

    def run(reqs):
        release.wait(timeout=10)
        return [r.seed for r in reqs]

    b = DynamicBatcher(run, batch_size=1, max_delay_s=0.01)
    f1 = b.submit(GenRequest("a", seed=1))
    f2 = b.submit(GenRequest("b", seed=2))
    f2.cancel()
    release.set()
    assert f1.result(timeout=10) == 1
    assert b.submit(GenRequest("c", seed=3)).result(timeout=10) == 3
    b.close()


# -------------------------------------------------------------------- HTTP
def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=None if body is None else
                 json.dumps(body), headers={"Content-Type":
                                            "application/json"})
    r = conn.getresponse()
    data = json.loads(r.read())
    conn.close()
    return r.status, data


def _png(data) -> np.ndarray:
    raw = base64.b64decode(data["image_png_base64"])
    with Image.open(io.BytesIO(raw)) as im:
        pil = np.asarray(im)
    assert np.array_equal(decode_png(raw), pil)
    return pil


@pytest.fixture
def stub_server():
    def run(reqs):
        return [np.full((8, 8, 3), min(r.seed, 255), np.uint8) for r in reqs]

    b = DynamicBatcher(run, batch_size=2, max_delay_s=0.01)
    srv = make_server(b, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    b.close()


def test_http_healthz(stub_server):
    status, data = _http(stub_server, "GET", "/healthz")
    assert status == 200 and data == {"status": "ok", "batch_size": 2}


def test_http_generate_returns_decodable_png(stub_server):
    status, data = _http(stub_server, "POST", "/generate",
                         {"prompt": "hi", "seed": 7})
    assert status == 200 and data["seed"] == 7
    assert data["guidance_scale"] == 7.5
    arr = _png(data)
    assert arr.shape == (8, 8, 3) and int(arr[0, 0, 0]) == 7


def test_http_bad_request_and_unknown_path(stub_server):
    status, data = _http(stub_server, "POST", "/generate", {"seed": 3})
    assert status == 400 and "prompt" in data["error"]
    assert _http(stub_server, "GET", "/nope")[0] == 404
    assert _http(stub_server, "POST", "/nope", {})[0] == 404


def test_http_concurrent_requests_batch_together(stub_server):
    out = {}

    def post(seed):
        out[seed] = _http(stub_server, "POST", "/generate",
                          {"prompt": "x", "seed": seed})

    ts = [threading.Thread(target=post, args=(s,)) for s in (11, 12)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert {out[11][0], out[12][0]} == {200}
    assert [int(_png(out[s][1])[0, 0, 0]) for s in (11, 12)] == [11, 12]


# ------------------------------------------------------- flags and refusals
@pytest.mark.parametrize("argv", [
    [], ["--sd3"], ["--sd3", "--image_length", "256", "--guidance_scale",
                    "5.0"],
    ["--erase_id", "sld", "--safe_level", "MAX", "--batch_size", "2",
     "--int8", "--export_aot", "b.sdt", "--port", "0"]],
    ids=["sd14", "sd3", "sd3-explicit", "flags"])
def test_parse_args_matches_jax(argv, tmp_path):
    """The same destinations and values as the JAX package's parser (the
    port adds --device), with a --config JSON's values as defaults."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"port": 9001, "num_inference_steps": 7}))
    for extra in ([], ["--config", str(cfg)]):
        mine = vars(t_serve.parse_args(argv + extra))
        assert mine.pop("device") == "cuda"
        assert mine == vars(j_serve.parse_args(argv + extra))
    sd3 = t_serve.parse_args(["--sd3"])
    assert (sd3.image_length, sd3.guidance_scale) == (1024, 2.5)


def test_serve_config_guards(tmp_path):
    """Misconfigurations the JAX server refuses, refused the same way,
    before --save-dir is used."""
    sd = str(tmp_path / "serve")
    for argv, match in (
            (["--model_dir", "x", "--erase_id", "std_rep"], "task_config"),
            (["--sd3", "--model_dir", "x", "--erase_id", "std_rep"],
             "task_config"),
            (["--sd3"], "model_dir"),
            (["--sd3", "--model_dir", "x", "--erase_id", "esd",
              "--erase_concept_checkpoint", "e.safetensors"],
             "erase_concept_checkpoint"),
            (["--sd3", "--model_dir", "x", "--erase_id", "sld"], "no SLD")):
        with pytest.raises(SystemExit, match=match):
            t_serve.main(argv + ["--save-dir", sd, "--device", "cpu"])


@pytest.mark.parametrize("extra", [[], ["--aot_bundle", "x.sdt"],
                                   ["--batch_size", "3"]])
def test_mesh_is_not_ported(tmp_path, extra):
    sd = tmp_path / "serve"
    with pytest.raises(NotImplementedError, match="--mesh"):
        t_serve.main(["--model_dir", "x", "--mesh", "2", "--save-dir",
                      str(sd), *extra])
    assert not sd.exists()


# ------------------------------------------------------------------ assets
@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Tiny HF-layout SD-v1 and SD3 checkpoints and a task YAML whose bank
    is a cached [4, 4, 8, 8] tensor (kernel_fast, beta gate off)."""
    from tests.test_torch_port_pipeline import _write_checkpoint
    from tests.test_torch_port_sd3 import write_tiny_sd3_checkpoint

    root = tmp_path_factory.mktemp("serve_assets")
    vocab = root / "vocab"
    vocab.mkdir()
    chip_smoke.write_tiny_vocab(str(vocab))
    _write_checkpoint(str(root / "ckpt"), str(vocab))
    write_tiny_sd3_checkpoint(str(root / "sd3"), str(vocab))
    bank = torch.randn(4, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    torch.save(bank / bank.norm(dim=1, keepdim=True), root / "bank.pt")
    yaml_text = f"""
repellency:
  method: kernel_fast
  n_embed: 2
  params:
    sigma: 30.0
    scale: 0.3
    beta_threshold: 1.0e-12
    cache_proj_ref: true
    proj_ref_path: {root / 'bank.pt'}
data:
  name: nudity
  root: {root}
  class_info: none
  size: 16
"""
    (root / "task.yaml").write_text(yaml_text)
    (root / "task_b.yaml").write_text(yaml_text.replace("scale: 0.3",
                                                        "scale: 0.2"))
    return SimpleNamespace(root=root, ckpt=str(root / "ckpt"),
                           sd3=str(root / "sd3"), task=str(root / "task.yaml"),
                           task_b=str(root / "task_b.yaml"))


def _argv(tiny, *extra, steps="2", sd3=False):
    return ["--model_dir", tiny.sd3 if sd3 else tiny.ckpt, "--batch_size",
            "2", "--num_inference_steps", steps, "--image_length", "16",
            "--device", "cpu", "--save-dir", str(tiny.root / "serve"),
            *(["--sd3"] if sd3 else []), *extra]


def _logger(tiny):
    return Logger(str(tiny.root / "serve_logs.txt"))


@pytest.fixture(scope="module")
def pipe(tiny):
    from safe_denoiser_tpu_torch.runners.common import build_pipeline
    args = t_serve.parse_args(_argv(tiny))
    return build_pipeline(args, _logger(tiny))


# ---------------------------------------------------------- bundle meta
def _jax_export_meta(monkeypatch, export, *args, **kwargs):
    monkeypatch.setattr(jax.export, "export",
                        lambda *a, **k: (lambda *a2, **k2: None))
    return export(*args, **kwargs).meta


def _same_meta(mine: dict, ref: dict) -> None:
    mine, ref = dict(mine), dict(ref)
    assert mine.pop("platform") == "cpu" and ref.pop("platform") == "cpu"
    assert mine.pop("torch_version") == torch.__version__
    ref.pop("jax_version")
    assert mine == ref


@pytest.mark.parametrize("erase_id", ["std", "std_rep", "sld", "safree"])
def test_bundle_meta_matches_jax(tiny, pipe, monkeypatch, erase_id):
    from safe_denoiser_tpu.pipeline.diffusion import \
        SafeDiffusionPipeline as JPipe
    from safe_denoiser_tpu.pipeline.diffusion import ERASE_SPECS as J_SPECS
    from safe_denoiser_tpu.repellency import RepellencyConfig as JRep

    rkw = dict(sigma=30.0, scale=0.3, beta_threshold=1e-12)
    rep = erase_id == "std_rep"
    refs = np.zeros((4, 4, 8, 8), np.float32)
    kw = dict(batch_size=2, num_inference_steps=3, height=16, width=16,
              safe_level="MEDIUM")
    mine = t_aot.export_pipeline(
        pipe, erase_spec=ERASE_SPECS[erase_id],
        repellency_cfg=RepellencyConfig(**rkw) if rep else None,
        refs=torch.from_numpy(refs) if rep else None, **kw).meta
    ref = _jax_export_meta(
        monkeypatch, j_aot.export_pipeline, JPipe.from_pretrained(tiny.ckpt),
        erase_spec=J_SPECS[erase_id],
        repellency_cfg=JRep(**rkw) if rep else None,
        refs=refs if rep else None, **kw)
    _same_meta(mine, ref)
    assert mine["branches"] == (3 if erase_id == "sld" else 2)


@pytest.mark.parametrize("rep", [False, True], ids=["std", "rep"])
def test_sd3_bundle_meta_matches_jax(tiny, monkeypatch, rep):
    from safe_denoiser_tpu.pipeline.sampler import RepellencyWindow as JWin
    from safe_denoiser_tpu.repellency import RepellencyConfig as JRep
    from safe_denoiser_tpu_torch.pipeline import RepellencyWindow
    from safe_denoiser_tpu_torch.pipeline.diffusion_sd3 import \
        SafeDiffusion3Pipeline
    from tests.test_torch_port_sd3 import _jax_sd3_pipeline

    rkw = dict(sigma=2.75, scale=0.03)
    refs = np.zeros((4, 4, 8, 8), np.float32)
    kw = dict(batch_size=1, num_inference_steps=4, height=16, width=16)
    mine = t_aot.export_pipeline_sd3(
        SafeDiffusion3Pipeline.from_pretrained(tiny.sd3, device="cpu"),
        repellency_cfg=RepellencyConfig(**rkw) if rep else None,
        refs=torch.from_numpy(refs) if rep else None,
        window=RepellencyWindow(1000.0, 880.0), **kw).meta
    ref = _jax_export_meta(
        monkeypatch, j_aot.export_pipeline_sd3, _jax_sd3_pipeline(tiny.sd3),
        repellency_cfg=JRep(**rkw) if rep else None,
        refs=refs if rep else None, window=JWin(1000.0, 880.0), **kw)
    _same_meta(mine, ref)


def test_bundle_guards(pipe, tmp_path):
    """The JAX package's test_aot_batch_and_platform_guards and its bank
    and branch refusals: batch, platform (at load), the bank, the branch
    count, generate() for a text method; FreeU cannot be baked."""
    bundle = t_aot.export_pipeline(pipe, batch_size=2, num_inference_steps=2,
                                   height=16, width=16)
    with pytest.raises(ValueError, match="exported for batch 2"):
        bundle.generate(pipe, ["one"], [1], [7.5])
    with pytest.raises(ValueError, match="refs must match"):
        bundle.generate(pipe, ["a", "b"], [1, 2], [7.5, 7.5],
                        refs=torch.zeros(3, 4, 8, 8))
    path = str(tmp_path / "bundle.sdt")
    t_aot.save_bundle(bundle, path)
    assert t_aot.load_bundle(path, device="cpu").meta == bundle.meta
    bundle.meta["platform"] = "cuda"
    t_aot.save_bundle(bundle, path)
    with pytest.raises(ValueError, match="platform-locked"):
        t_aot.load_bundle(path, device="cpu")
    sld = t_aot.export_pipeline(pipe, batch_size=2, num_inference_steps=2,
                                height=16, width=16,
                                erase_spec=ERASE_SPECS["sld"])
    with pytest.raises(ValueError, match="generate_prepared"):
        sld.generate(pipe, ["a", "b"], [1, 2], [7.5, 7.5])
    with pytest.raises(ValueError, match="branches"):
        sld.generate_prepared(pipe, torch.zeros(2, 2, 77, 32),
                              torch.zeros(2, 2, 77, 32),
                              torch.zeros(2, 2, dtype=torch.bool), [1, 2],
                              [7.5, 7.5])
    from safe_denoiser_tpu_torch.models import FreeUConfig
    with pytest.raises(ValueError, match="FreeU"):
        t_aot.export_pipeline(pipe, batch_size=2, freeu=FreeUConfig())


# --------------------------------------------------------- end to end
def _reqs(prompts, seeds, gs):
    return [GenRequest(p, seed=s, guidance_scale=g)
            for p, s, g in zip(prompts, seeds, gs)]


def test_serve_end_to_end_equals_generate_batch(tiny, pipe):
    """parse_args -> build_run_batch -> start_server (its warm-up batch)
    -> three concurrent HTTP requests on batch 2 (a full batch and a
    padded one): each PNG equals generate_batch on the batch the batcher
    formed around it (its seeds and guidance scales) bit for bit; the
    two-phase path through the batcher equals the synchronous one."""
    from safe_denoiser_tpu_torch.runners.common import build_repellency

    args = t_serve.parse_args(_argv(tiny, "--port", "0", "--erase_id",
                                    "std_rep", "--task_config", tiny.task,
                                    "--max_delay_ms", "500"))
    logger = _logger(tiny)
    run_batch = t_serve.build_run_batch(args, logger)
    groups, dispatch = [], run_batch.dispatch_batch

    def recording(reqs):
        groups.append(list(reqs))
        return dispatch(reqs)

    run_batch.dispatch_batch = recording
    batcher, srv = t_serve.start_server(args, run_batch, logger)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    reqs = [("a cat", 5, 7.5), ("a dog", 6, 3.0), ("a bird", 7, 7.5)]
    out = {}

    def post(req):
        out[req[1]] = _http(port, "POST", "/generate", {
            "prompt": req[0], "seed": req[1], "guidance_scale": req[2]})

    threads = [threading.Thread(target=post, args=(r,)) for r in reqs]
    try:
        assert _http(port, "GET", "/healthz")[1]["batch_size"] == 2
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
    assert sorted(len({r.seed for r in g}) for g in groups) == [1, 2]
    proc, _ = build_repellency(args, pipe, logger)
    for group in groups:
        want = pipe.generate_batch(
            [r.prompt for r in group], [r.seed for r in group],
            [r.guidance_scale for r in group], num_inference_steps=2,
            height=16, width=16, repellency_processor=proc,
            erase_spec=ERASE_SPECS["std_rep"])
        for row, r in enumerate(group):
            if group.index(r) < row:
                continue        # a padding row, repeating the last request
            status, data = out[r.seed]
            assert status == 200, data
            assert np.array_equal(_png(data), want[row]), r.seed

    sync = run_batch(_reqs(["a cat", "a dog"], [3, 4], [7.5, 6.0])) + \
        run_batch(_reqs(["a cat", "a bus"], [5, 6], [7.5, 7.5]))
    b = DynamicBatcher(run_batch, 2, max_delay_s=0.5,
                       dispatch_batch=dispatch)
    futs = [b.submit(r) for r in _reqs(["a cat", "a dog", "a cat", "a bus"],
                                       [3, 4, 5, 6], [7.5, 6.0, 7.5, 7.5])]
    piped = [f.result(timeout=120) for f in futs]
    b.close()
    for a, c in zip(piped, sync):
        assert np.array_equal(a, c)


@pytest.mark.parametrize("erase_id", ["std", "std_rep", "sld", "safree"])
def test_bundle_round_trip_equals_live(tiny, erase_id, monkeypatch):
    """--export_aot, then --aot_bundle with the same flags: the bundle's
    run_batch equals the live one bit for bit (the JAX package's
    test_serve_runner_aot_*, port against port); a bundle served with
    other steps, batch, erase id, int8, task YAML or SLD level is
    refused."""
    extra = ["--erase_id", erase_id, "--negative_prompt_space",
             "naked, nsfw", "--safe_level", "MEDIUM"]
    if erase_id == "std_rep":
        extra += ["--task_config", tiny.task]
    path = str(tiny.root / f"{erase_id}.sdt")
    t_serve.main(_argv(tiny, *extra, "--export_aot", path, steps="3"))
    with zipfile.ZipFile(path) as z:
        assert z.namelist() == ["meta.json"]
        meta = json.loads(z.read("meta.json"))
    assert meta["text_method"] == ERASE_SPECS[erase_id].text_method
    logger = _logger(tiny)
    run_aot = t_serve.build_run_batch(t_serve.parse_args(
        _argv(tiny, *extra, "--aot_bundle", path, steps="3")), logger)
    run_live = t_serve.build_run_batch(t_serve.parse_args(
        _argv(tiny, *extra, steps="3")), logger)
    reqs = _reqs(["a cat", "a dog"], [3, 4], [7.5, 6.0])
    for a, b in zip(run_aot(reqs), run_live(reqs)):
        assert np.array_equal(a, b)

    def refused(match, *more, base=extra):
        with pytest.raises(SystemExit, match=match):
            t_serve.build_run_batch(t_serve.parse_args(_argv(
                tiny, *base, "--aot_bundle", path, *more, steps="3")),
                logger)

    refused("num_inference_steps", "--num_inference_steps", "4")
    refused("batch_size", "--batch_size", "4")
    monkeypatch.setenv("SDT_INT8_MIN_DIM", "64")  # the tiny UNet's widths
    refused("int8", "--int8")
    other = "std" if erase_id == "safree" else "safree"
    refused("text_method", base=["--erase_id", other,
                                 "--negative_prompt_space", "naked"])
    if erase_id == "std_rep":
        refused("repellency_cfg", base=["--erase_id", "std_rep",
                                        "--task_config", tiny.task_b])
    if erase_id == "sld":
        refused("safe_level", "--safe_level", "MAX")


def test_bundle_serves_new_weights_in_place(tiny, pipe):
    """One bundle, two checkpoints of the architecture (the JAX package's
    test_aot_is_weight_independent): after load_state_dict into the same
    modules the bundle's images change."""
    bundle = t_aot.export_pipeline(pipe, batch_size=1, num_inference_steps=2,
                                   height=16, width=16)
    a = bundle.generate(pipe, ["x"], [1], [7.5])
    saved = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    try:
        pipe.unet.load_state_dict({k: v + 0.01 if v.is_floating_point()
                                   else v for k, v in saved.items()})
        b = bundle.generate(pipe, ["x"], [1], [7.5])
    finally:
        pipe.unet.load_state_dict(saved)
    assert not np.array_equal(a[0], b[0])


def test_sd3_serving_live_and_bundle(tiny):
    """--sd3: the live run_batch (kernel_fast through the task YAML's
    cached bank) equals generate_batch; its bundle equals it bit for bit;
    an SD3 bundle refuses an SD-v1 server and a batch mismatch."""
    extra = ["--erase_id", "std_rep", "--task_config", tiny.task]
    logger = _logger(tiny)
    path = str(tiny.root / "sd3.sdt")
    t_serve.main(_argv(tiny, *extra, "--export_aot", path, sd3=True))
    run_live = t_serve.build_run_batch(
        t_serve.parse_args(_argv(tiny, *extra, sd3=True)), logger)
    run_aot = t_serve.build_run_batch(
        t_serve.parse_args(_argv(tiny, *extra, "--aot_bundle", path,
                                 sd3=True)), logger)
    reqs = _reqs(["a cat", "a dog"], [5, 9], [7.0, 2.5])
    live, aot = run_live(reqs), run_aot(reqs)
    assert live[0].shape == (16, 16, 3) and not np.array_equal(*live)
    for a, b in zip(aot, live):
        assert np.array_equal(a, b)
    with pytest.raises(SystemExit, match="sd3"):
        t_serve.build_run_batch(t_serve.parse_args(
            _argv(tiny, *extra, "--aot_bundle", path)), logger)
    with pytest.raises(SystemExit, match="batch_size"):
        t_serve.build_run_batch(t_serve.parse_args(
            _argv(tiny, *extra, "--aot_bundle", path, "--batch_size", "4",
                  sd3=True)), logger)
