"""The plain reference against the system at a tiny size on the CPU, both
in fp32 from the same seeded weights: the UNet, the first stage and the
conditioner agree to fp32's rounding."""

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import Reference
from benchmark.tests import tiny

TOL = 1e-4  # fp32 against fp32: the order of the sums differs, nothing else


@pytest.fixture(scope="module")
def pair():
    from vista_tpu_torch.engine.engine import VistaEngine

    cfg = tiny.config(tiny.SAMPLE)
    eng = VistaEngine(harness.engine_config(cfg), "cpu")
    weights.fill_(harness.components(eng), 11)
    ref = Reference(cfg, "cpu", 11, harness.engine_layout(eng))
    return cfg, eng, ref


def test_same_parameters_and_values(pair):
    _, eng, ref = pair
    mine = weights.named(harness.components(eng))
    theirs = weights.named(ref.parts)
    assert mine.keys() == theirs.keys()
    for n in mine:
        assert torch.equal(mine[n][0].float(), theirs[n][0]), n


def test_unet(pair):
    cfg, eng, ref = pair
    u, t = cfg["engine"]["unet"], cfg["engine"]["num_frames"]
    gen = torch.Generator().manual_seed(0)
    n = 2 * t
    args = (torch.randn(n, u["in_channels"], 16, 16, generator=gen), torch.rand(n, generator=gen),
            torch.randn(2, 1, u["context_dim"] + 128 * 19, generator=gen),
            torch.randn(2, u["adm_in_channels"], generator=gen), (torch.rand(n, generator=gen) > 0.5).float())
    with torch.no_grad():
        assert harness.rel(eng.unet(*args, t), ref.unet(*args, t)) < TOL


def test_first_stage_and_conditioner(pair):
    cfg, eng, ref = pair
    gen = torch.Generator().manual_seed(1)
    px = torch.randn(3, 3, 32, 32, generator=gen) * 0.3
    noise = torch.randn(3, 4, 16, 16, generator=gen)
    with torch.no_grad():
        assert harness.rel(eng.encode_first_stage(px, noise), ref.encode(px, noise)) < TOL
        z = torch.randn(3, 4, 16, 16, generator=gen)
        assert harness.rel(eng.decoder(z, 3), ref.decoder(z, 3)) < TOL
        batch = {"cond_frames_without_noise": px[:1], "cond_frames": px[:1],
                 "fps_id": torch.tensor([9.0]), "motion_bucket_id": torch.tensor([127.0]),
                 "cond_aug": torch.tensor([0.02]), "trajectory": torch.randn(1, 8, generator=gen)}
        for force in (frozenset(), frozenset({"cond_frames", "trajectory"})):
            got, want = eng.conditions(batch, force), ref.conditions(batch, force)
            for k in want:
                assert harness.rel(got[k], want[k]) < TOL, k
