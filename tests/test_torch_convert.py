"""The port's weights-out path against the JAX package, on the CPU:

- ``bin_to_state_dict`` and ``merge_lora_weights`` against
  ``vista_tpu.utils.checkpoint``'s on one seeded numpy dict in the
  DeepSpeed layout (``_forward_module.`` keys, LoRA adapters on the online
  and the name-mangled ``model_ema`` copies, ``to_out0`` among them, the
  EMA counters): the same keys, the same values bit for bit;
- the tiny engine's ``export_vista_state_dict`` (LoRA + action control,
  weights carried across from random JAX params): its keys and values equal
  ``export_vista_checkpoint``'s, and it round-trips bit for bit through the
  port's safetensors writer and reader and ``load_vista_state_dict``;
- the port's safetensors reader and writer against the ``safetensors``
  package, in both directions, every dtype the port handles (BF16 through
  torch);
- ``python -m vista_tpu_torch.cli.convert`` in-process on files under
  ``tmp_path``: a ``.bin`` pickle to ``.safetensors`` (equal to the JAX
  pipeline's dict); a tiny LoRA + action ``Runner`` checkpoint with
  ``--merge-lora`` to ``.safetensors``, which the tiny sample CLI loads with
  ``--ckpt --device cpu`` (``strict=True``) and samples from within
  ``MERGE_TOL`` of the same round from the runner's own EMA modules with
  LoRA unmerged;
  ``.safetensors`` back to the port's checkpoint and out again, bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu.utils import checkpoint as jio
from vista_tpu_torch.cli import convert
from vista_tpu_torch.cli import sample as sample_cli
from vista_tpu_torch.cli import train as train_cli
from vista_tpu_torch.cli._common import build_engine
from vista_tpu_torch.engine.engine import VistaEngine
from vista_tpu_torch.utils import checkpoint as io

# merged against unmerged LoRA: a LoRA UNet takes another self-attention
# route (layer_norm, then the products and their adapters) than the merged
# one (the fused LN + q/k/v); with zero adapters, where the merge changes
# nothing, the two read 8.3e-5 on this path
MERGE_TOL = 5e-4
TINY = str(Path(__file__).resolve().parent.parent / "configs" / "tiny_smoke.yaml")


def _mangle(name: str) -> str:
    return name.replace(".", "")


def bin_state_dict(seed=0):
    """A DeepSpeed-style dict: two attention blocks with LoRA on every
    projection, online and EMA (mangled names, other values), a frozen
    decoder key, the EMA counters, everything under ``_forward_module.``."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: rng.standard_normal(s).astype(np.float32)
    online = {"first_stage_model.decoder.conv.weight": rnd(4, 4)}
    for blk in ("input_blocks.1.1.transformer_blocks.0.attn1.",
                "output_blocks.2.1.time_stack.0.attn2."):
        base = "model.diffusion_model." + blk
        for p in ("to_q", "to_k", "to_v", "to_out.0"):
            online[base + p + ".weight"] = rnd(8, 8)
        for p in ("q", "k", "v", "out"):
            online[base + f"{p}_adapter_down.weight"] = rnd(2, 8)
            online[base + f"{p}_adapter_up.weight"] = rnd(8, 2)
    ema = {"model_ema." + _mangle(k[len("model."):]): rnd(*v.shape)
           for k, v in online.items() if k.startswith("model.")}
    ema["model_ema.decay"] = np.float32(0.9999)
    ema["model_ema.num_updates"] = np.int64(123)
    return {"_forward_module." + k: v for k, v in {**online, **ema}.items()}


def assert_same(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k


def test_bin_to_state_dict_and_merge_match_jax():
    sd = bin_state_dict()
    out = io.bin_to_state_dict(sd)
    assert_same(out, jio.bin_to_state_dict(sd))
    assert "model.diffusion_model.input_blocks.1.1.transformer_blocks.0.attn1.to_out.0.weight" \
        in out and not any("model_ema" in k or "adapter" in k for k in out)
    clean = {k.removeprefix("_forward_module."): v for k, v in sd.items()
             if "model_ema" not in k}
    for scale in (1.0, 0.5):
        assert_same(io.merge_lora_weights(clean, scale), jio.merge_lora_weights(clean, scale))


@pytest.fixture(scope="module")
def carried():
    """The tiny engine with LoRA + action control, its weights carried
    across from random JAX params (``build`` of the conditioner test)."""
    from tests.test_torch_conditioner import build

    jeng, params, port = build(lora=True, seed=31)
    return jeng, params, port


def test_export_equals_jax_and_round_trips(carried, tmp_path):
    jeng, params, port = carried
    ref = jio.export_vista_checkpoint(params, jeng.cfg)
    got = io.export_vista_state_dict(port.unet, port.decoder, port.encoder, port.conditioner)
    assert_same(got, ref)
    path = str(tmp_path / "tiny.safetensors")
    io.save_safetensors(path, got)
    fresh = VistaEngine(port.cfg, "cpu")
    io.load_vista_state_dict(fresh.unet, fresh.decoder, path, encoder=fresh.encoder,
                             conditioner=fresh.conditioner)
    assert_same(io.export_vista_state_dict(fresh.unet, fresh.decoder, fresh.encoder,
                                           fresh.conditioner), got)


def test_safetensors_against_the_package(tmp_path):
    st_np = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(5)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f64": rng.standard_normal((2,)), "f16": rng.standard_normal((4, 1, 2)).astype(
                  np.float16),
              "i64": rng.integers(-9, 9, (7,)), "i32": rng.integers(0, 9, (2, 2)).astype(np.int32),
              "u8": rng.integers(0, 255, (5,)).astype(np.uint8), "b": rng.random(3) > 0.5,
              "i8": rng.integers(-9, 9, (3,)).astype(np.int8), "scalar": np.array(2.5, np.float32),
              "empty": np.zeros((0, 4), np.float32)}
    theirs, mine = str(tmp_path / "theirs.safetensors"), str(tmp_path / "mine.safetensors")
    st_np.save_file(arrays, theirs)
    assert_same(io.load_safetensors(theirs), arrays)
    io.save_safetensors(mine, arrays)
    assert_same(st_np.load_file(mine), arrays)
    bf = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(1)).bfloat16()}
    st_torch.save_file(bf, theirs)
    assert np.array_equal(io.load_safetensors(theirs)["w"], bf["w"].float().numpy())
    io.save_safetensors(mine, bf)
    assert torch.equal(st_torch.load_file(mine)["w"], bf["w"])


def test_cli_bin_to_safetensors(tmp_path):
    sd = bin_state_dict(1)
    path = tmp_path / "pytorch_model.bin"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    out = str(tmp_path / "vista.safetensors")
    convert.main(["--input", str(path), "--output", out])
    assert_same(io.load_safetensors(out), jio.bin_to_state_dict(sd))


def test_cli_runner_checkpoint_to_sample_ckpt(tmp_path, monkeypatch):
    logdir = tmp_path / "run"
    runner = train_cli.main([
        f"run.logdir={logdir}", "run.max_steps=2", "run.val_every=1000",
        "run.image_log_steps=1", "data.num_threads=1", "train.policy=lora_only",
        "train.learning_rate=0.05", "train.warmup_steps=0", "engine.unet.add_lora=true",
        "engine.unet.action_control=true", "engine.conditioner.action_control=true",
        "--base", TINY, "--device", "cpu", "--synthetic-data"])
    ckpt = logdir / "checkpoints" / "last"
    merged = str(tmp_path / "merged.safetensors")
    convert.main(["--input", str(ckpt), "--output", merged, "--merge-lora", "--lora-scale", "1"])
    sd = io.load_safetensors(merged)
    assert not any("adapter_down" in k or "adapter_up" in k for k in sd)
    assert any("adapter_action_control" in k for k in sd)

    # the sample CLI's tiny engine (no LoRA, action control) loads it strictly
    argv = ["--tiny", "--device", "cpu", "--action", "traj", "--n_rounds", "1",
            "--n_steps", "2", "--seed", "3"]
    args = sample_cli.parse_args(argv + ["--ckpt", merged, "--save", str(tmp_path / "a")])
    engine = build_engine(args)
    got = sample_cli.run(args, engine)["latents"]
    # the same round from the runner's own EMA modules, LoRA unmerged
    ref_args = sample_cli.parse_args(argv + ["--save", str(tmp_path / "b")])
    with runner.trainer.ema_weights():
        ref = sample_cli.run(ref_args, runner.engine)["latents"]
    moved = [n for n in runner.trainer.ema if "adapter_up" in n
             and not torch.equal(runner.trainer.ema[n], torch.zeros_like(runner.trainer.ema[n]))]
    assert moved  # the LoRA up-projections left zero, so the merge matters
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= MERGE_TOL

    # .safetensors -> the port's checkpoint -> .safetensors, bit for bit
    monkeypatch.setattr(convert, "engine_config", lambda a: engine.cfg)
    native = str(tmp_path / "modules.pt")
    convert.main(["--input", merged, "--output", native])
    again = str(tmp_path / "again.safetensors")
    convert.main(["--input", native, "--output", again])
    assert_same(io.load_safetensors(again), sd)


def test_cli_rejects_unknown_input(tmp_path):
    path = tmp_path / "weights.npz"
    torch.save({"a": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="not the port's checkpoint"):
        convert.main(["--input", str(path), "--output", str(tmp_path / "x.safetensors")])
