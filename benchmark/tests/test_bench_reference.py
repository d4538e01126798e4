"""The plain reference against the port at tiny widths on the CPU, through
the whole harness: in float32 the two agree to rounding, so the reference
computes what the port's plain forms compute; in bfloat16 the sound
program passes, and the check fails the program with its timed path
broken underneath and the reference's own lower-precision control."""

import pytest

from benchmark.control import fp8, reference_control
from benchmark.harness import check, runner
from benchmark.harness.spec import BENCH, load_json
from benchmark.reference import sample as ref
from benchmark.tests import tiny

CASES = {
    "sd1-ddpm-batch": (tiny.sd1_config, "batch4-512-ddpm50"),
    "sd1-ddim-open": (tiny.sd1_config, "open-512-ddim10"),
    "sd3-flow-batch": (tiny.sd3_config, "batch1-1024-flow50"),
}
# the tiny cells' limit: sound bf16 runs read 0.02-0.06, the float8
# control and the broken paths 0.2 and more
LIMIT = 0.12


def run(cell, seed=2 ** 31 + 11):
    return runner.run_cell(cell, seed, 0.6, trace=False, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_the_port_in_f32(case):
    config, mix = CASES[case]
    # the open loop keeps no latents: only its images and text states
    numbers = (tuple(check.NEEDS) if mix.startswith("batch") else
               ("image_rel_rms", "image_mean_abs", "encode_rel_rms"))
    res = run(tiny.cell(config("float32"), tiny.traffic(mix),
                        numbers=numbers))
    found = res["candidates"]
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert found["image_rel_rms"] <= 1e-3
    assert found["image_mean_abs"] <= 0.05
    assert found["encode_rel_rms"] <= 1e-4
    if mix.startswith("batch"):     # the batch loads keep the latents
        assert found["latent_rel_rms"] <= 1e-4
        assert found["decode_rel_rms"] <= 1e-3


@pytest.mark.parametrize("case", sorted(CASES))
def test_sound_bf16_program_passes(case):
    config, mix = CASES[case]
    res = run(tiny.cell(config(), tiny.traffic(mix), limit=LIMIT))
    assert res["correct"], res["candidates"]
    assert list(res)[-1] == "checked"
    assert res["checked"]["image_rel_rms"]["limit"] == LIMIT


def _step_unchanged(monkeypatch):
    from safe_denoiser_tpu_torch.schedulers import ddpm
    monkeypatch.setattr(ddpm.DDPMScheduler, "step",
                        lambda self, eps, t, sample, n, noise=None,
                        generator=None: (sample, sample))


def _answer_altered(monkeypatch):
    from safe_denoiser_tpu_torch.pipeline import diffusion
    real = diffusion.postprocess_image_host
    monkeypatch.setattr(diffusion, "postprocess_image_host",
                        lambda image: (real(image) * 0.8).clamp(0, 1))


def _half_batch_left_out(monkeypatch):
    from safe_denoiser_tpu_torch.pipeline import diffusion
    real = diffusion.SafeDiffusionPipeline.dispatch_batch

    def half(self, prompts, seeds, guidance_scales, **kw):
        h = len(prompts) // 2
        keep = lambda xs: list(xs[:h]) * 2 + list(xs[:len(xs) - 2 * h])  # noqa
        return real(self, keep(prompts), keep(seeds), keep(guidance_scales),
                    **kw)

    monkeypatch.setattr(diffusion.SafeDiffusionPipeline, "dispatch_batch",
                        half)


@pytest.mark.parametrize("fault", [_step_unchanged, _answer_altered,
                                   _half_batch_left_out])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    """At sd14-batch's own batch and sample size."""
    fault(monkeypatch)
    mix = load_json(BENCH / "traffic/batch4-512-ddpm50.json")
    limits = load_json(BENCH / "limits/sd14-batch.json")
    cell = tiny.cell(tiny.sd1_config(),
                     tiny.traffic("batch4-512-ddpm50", batch=mix["batch"]),
                     limit=LIMIT, sample=limits["sample"])
    res = run(cell)
    assert not res["correct"], res["candidates"]


@pytest.mark.parametrize("seed", range(20))
def test_the_sample_checks_every_row_of_a_batch(seed):
    served = [check.Served(k, None, None, k % 4) for k in range(100)]
    picked = check.pick(served, seed, 4)
    assert sorted(s.row for s in picked) == [0, 1, 2, 3]
    picked = check.pick(served[:3] + [s for s in served if s.row == 0],
                        seed, 6)
    assert [s.row for s in picked].count(0) == 4   # rows present, in turn


@pytest.mark.parametrize("change", [{"method": "spell"},
                                    {"beta_gate": True}])
def test_a_repellency_not_implemented_is_refused(change):
    mix = tiny.traffic("batch4-512-ddpm50")
    mix["repellency"].update(change)
    with pytest.raises(ValueError):
        ref.check_recipe(mix)
    with pytest.raises(ValueError):
        run(tiny.cell(tiny.sd1_config(), mix))


def test_float8_control_is_not_correct():
    cell = tiny.cell(tiny.sd1_config(), tiny.traffic("batch4-512-ddpm50"),
                     limit=LIMIT)
    for seed in (3, 4, 5):
        assert reference_control(cell, seed, "cpu", fp8)["image_rel_rms"] \
            > LIMIT


# SD3's numbers at tiny widths: sound bf16 runs read latents 0.0007-0.0008
# and text states 0.004-0.005; float8 everywhere 0.004 and 0.04, in the
# MMDiT alone 0.004 on the latents, in T5 alone 0.04 on the text states
SD3_NUMBERS = {"latent_rel_rms": 0.002, "encode_rel_rms": 0.015,
               "decode_rel_rms": LIMIT}


def test_sd3_numbers_pass_sound_and_fail_float8():
    cell = tiny.cell(tiny.sd3_config(), tiny.traffic("batch1-1024-flow50"),
                     numbers=tuple(SD3_NUMBERS), sample=1)
    for name, limit in SD3_NUMBERS.items():
        cell.limits["numbers"][name]["limit"] = limit
    res = run(cell)
    assert res["correct"], res["candidates"]
    for quant in (fp8, {"transformer": fp8}):
        found = reference_control(cell, 3, "cpu", quant)
        assert found["latent_rel_rms"] > SD3_NUMBERS["latent_rel_rms"], found
    found = reference_control(cell, 3, "cpu", {"text_encoder_3": fp8})
    assert found["encode_rel_rms"] > SD3_NUMBERS["encode_rel_rms"], found
