"""The port's typed configs, datasets, native binding and input pipeline
against the JAX package's, on the CPU (numpy and PIL; nothing is jitted):

- every shipped YAML loads into the port's ``ExperimentConfig`` and its
  ``to_dict`` equals the JAX load's without the UNet's TPU-only keys; merge,
  overrides, unknown keys, the TPU-only keys' rules, save -> load; the
  recipes ``chip_smoke.py`` builds from the YAMLs equal the ones it built by
  hand before;
- on JPEG and PNG clips written here (small source frames, 64x64 targets):
  ``YouTubeFramesDataset`` and ``NuScenesDataset`` give the same arrays and
  action dicts as the JAX package's for indices 0-7 called in the same
  order (the modality cycling is stateful); the oversampling lists, the
  synthetic clips and the first 4 batches of a one-thread two-source
  pipeline are equal; the bounded retry raises; a worker's error reaches
  the consumer and ``stop`` ends the threads;
- the native library (built with ``make -C native`` where it is missing and
  a toolchain exists): the port's binding gives the bits of
  ``vista_tpu.data.native``, and stays within the native-vs-PIL bound of
  ``tests/test_native_host.py``; ``VISTA_HOST_LIB`` naming no file sends the
  datasets to PIL.
"""

import dataclasses
import io
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from vista_tpu import config as jconfig
from vista_tpu import runner as jrunner
from vista_tpu.data import datasets as jdatasets
from vista_tpu.data import native as jnative
from vista_tpu.data import pipeline as jpipeline
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch import config
from vista_tpu_torch import runner
from vista_tpu_torch.data import datasets, native, pipeline

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
UNET_TPU_ONLY = ("attn_backend",)
REMAT_OVERRIDES = ["engine.unet.remat_max_ds=2", "engine.unet.remat_max_ds=1",
                   "engine.unet.remat_policy=names", "engine.unet.remat_policy=dots"]
SIZE = 64


def _jax_dict(paths, overrides=()):
    d = jconfig.to_dict(jconfig.load_config(jrunner.ExperimentConfig, paths, overrides))
    d["engine"]["unet"] = {k: v for k, v in d["engine"]["unet"].items()
                           if k not in UNET_TPU_ONLY}
    return d


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_shipped_config_loads_as_jax(path):
    cfg = config.load_config(runner.ExperimentConfig, [str(path)])
    assert isinstance(cfg, runner.ExperimentConfig)
    assert config.to_dict(cfg) == _jax_dict([str(path)])


def test_merge_and_overrides(tmp_path):
    overlay = tmp_path / "overlay.yaml"
    overlay.write_text(json.dumps({"train": {"policy": "lora_only"},
                                   "engine": {"unet": {"add_lora": True}},
                                   "data": {"sources": [{"kind": "synthetic", "length": 9}]}}))
    paths = [str(ROOT / "configs" / "tiny_smoke.yaml"), str(overlay)]
    overrides = ["run.max_steps=7", "train.loss.cond_frames_choices=[[], [1]]",
                 "run.logdir=somewhere/else", "data.seed=3", "engine.unet.remat=true"]
    cfg = config.load_config(runner.ExperimentConfig, paths, overrides)
    assert cfg.run.max_steps == 7 and cfg.run.logdir == "somewhere/else"
    assert cfg.train.policy == "lora_only" and cfg.engine.unet.add_lora
    assert cfg.train.loss.cond_frames_choices == ((), (1,))
    assert cfg.data.sources == (pipeline.SourceConfig(kind="synthetic", length=9),)
    assert cfg.engine.unet.remat and cfg.engine.unet.model_channels == 32  # tiny_smoke's
    assert config.to_dict(cfg) == _jax_dict(paths, overrides)
    with pytest.raises(ValueError, match="key=value"):
        config.apply_overrides({}, ["run.max_steps"])


@pytest.mark.parametrize("override", ["engine.unet.bogus=1", "run.nope=2", "nothing=3",
                                      "data.sources=[{\"kind\": \"youtube\", \"x\": 1}]"])
def test_unknown_key_raises(override):
    path = str(ROOT / "configs" / "tiny_smoke.yaml")
    with pytest.raises(KeyError, match="unknown config keys"):
        config.load_config(runner.ExperimentConfig, [path], [override])


def test_tpu_only_keys(capsys):
    path = str(ROOT / "configs" / "tiny_smoke.yaml")
    for value in ("pallas", "xla", "anything"):
        cfg = config.load_config(runner.ExperimentConfig, [path],
                                 [f"engine.unet.attn_backend={value}"])
        assert "attn_backend" in capsys.readouterr().out
        assert cfg == config.load_config(runner.ExperimentConfig, [path])
    nulls = ["engine.unet.remat_max_ds=null", "engine.unet.remat_policy=null"]
    assert config.load_config(runner.ExperimentConfig, [path], nulls) == config.load_config(
        runner.ExperimentConfig, [path])
    for key, value in (("remat_max_ds", 2), ("remat_policy", "names"),
                       ("remat_policy", "dots")):
        override = [f"engine.unet.{key}={value}"]
        cfg = config.load_config(runner.ExperimentConfig, [path], override)
        assert getattr(cfg.engine.unet, key) == value
        assert config.to_dict(cfg) == _jax_dict([path], override)
    with pytest.raises(ValueError, match="unknown remat_policy 'bogus'"):
        config.load_config(runner.ExperimentConfig, [path], ["engine.unet.remat_policy=bogus"])
    # the keys are the UNet's: anywhere else they are unknown
    with pytest.raises(KeyError):
        config.load_config(runner.ExperimentConfig, [path], ["engine.vae.attn_backend=xla"])


@pytest.mark.parametrize("override", REMAT_OVERRIDES)
@pytest.mark.parametrize("path", [p for p in CONFIGS if p.name.startswith("vista_")],
                         ids=lambda p: p.name)
def test_remat_keys_load_as_jax(path, override):
    """The selective-checkpointing keys from a dotlist over each shipped
    Vista recipe: the values the JAX loader gives, and a round trip."""
    cfg = config.load_config(runner.ExperimentConfig, [str(path)], [override])
    key, value = override.rsplit(".", 1)[1].split("=")
    assert cfg.engine.unet.remat and str(getattr(cfg.engine.unet, key)) == value
    assert config.to_dict(cfg) == _jax_dict([str(path)], [override])


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_save_load_round_trip(path, tmp_path):
    cfg = config.load_config(runner.ExperimentConfig, [str(path)])
    out = tmp_path / "config.yaml"
    config.save_config(cfg, str(out))
    assert not set(UNET_TPU_ONLY) & set(yaml.safe_load(out.read_text())["engine"]["unet"])
    assert config.load_config(runner.ExperimentConfig, [str(out)]) == cfg


def test_chip_smoke_recipes_equal_hand_built():
    """``chip_smoke.py``'s phase-2 and phase-1 recipes, now loaded from the
    YAMLs, equal the configs it built by hand before."""
    import chip_smoke
    from vista_tpu_torch.diffusion.loss import LossConfig
    from vista_tpu_torch.engine.engine import EngineConfig
    from vista_tpu_torch.engine.training import TrainConfig

    loss = LossConfig(num_frames=25, sigma_p_mean=1.0, sigma_p_std=1.6, weighting="v",
                      use_additional_loss=True, additional_loss_weight=0.1,
                      replace_cond_frames=True)
    base = EngineConfig()
    phase2 = (dataclasses.replace(
        base, unet=dataclasses.replace(base.unet, add_lora=True, action_control=True,
                                       remat=True),
        conditioner=dataclasses.replace(base.conditioner, action_control=True, ucg_rate=0.15,
                                        ucg_keys=chip_smoke.PHASE2_UCG_KEYS)),
        TrainConfig(learning_rate=5e-5, warmup_steps=1000, grad_clip=0.3, policy="lora_only",
                    ema_decay=0.9999, loss=loss))
    phase1 = (dataclasses.replace(
        base, unet=dataclasses.replace(base.unet, remat=True),
        conditioner=dataclasses.replace(base.conditioner, ucg_rate=0.15)),
        TrainConfig(learning_rate=5e-5, warmup_steps=1000, grad_clip=0.3, accum_steps=2,
                    policy="slow_spatial", slow_spatial_factor=0.1, ema_decay=0.9999,
                    loss=loss))
    assert chip_smoke.phase2_cfg() == phase2
    assert chip_smoke.phase1_cfg() == phase1


# ---------------------------------------------------------------- datasets

def _frame(rng, w, h):
    base = rng.randint(0, 256, (max(h // 8, 1), max(w // 8, 1), 3), np.uint8)
    return Image.fromarray(base).resize((w, h), Image.BILINEAR)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Clips in both layouts and both formats: OpenDV folders of 4:3 frames
    (2 videos, 7 frames) and nuScenes frames at 16:9 with 7 annotations of
    every shape the modality dispatch and the oversampling read."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.RandomState(0)
    for ext in (".jpg", ".png"):
        for v in range(2):
            folder = root / f"opendv{ext}" / f"video{v}"
            folder.mkdir(parents=True)
            for i in range(7):
                _frame(rng, 96, 72).save(folder / f"{i:09d}{ext}")
        folder = root / f"nusc{ext}" / "CAM"
        folder.mkdir(parents=True)
        for i in range(7):
            _frame(rng, 160, 90).save(folder / f"{i:03d}{ext}")
        (root / f"opendv{ext}.json").write_text(json.dumps(
            [{"folder": f"video{v}", "first_frame": f} for v in range(2) for f in (0, 2)]))
        annos = []
        for i in range(7):
            anno = {"frames": [f"CAM/{(i + j) % 7:03d}{ext}" for j in range(4)],
                    "traj": rng.randn(10).tolist(), "cmd": i % 4,
                    "speed": (rng.rand(5) * 10).tolist() if i != 2 else [],
                    "angle": (rng.randn(5) * 100).tolist() if i != 4 else [],
                    "goal": [float(rng.randint(-100, 1800)), float(rng.randint(-50, 1000))],
                    "z": float(rng.randn())}
            if i == 5:
                del anno["traj"]
            annos.append(anno)
        (root / f"nusc{ext}.json").write_text(json.dumps(annos))
    return root


def _ds_cfgs(clips, kind, ext):
    kw = dict(anno_file=str(clips / f"{kind}{ext}.json"), data_root=str(clips / f"{kind}{ext}"),
              height=SIZE, width=SIZE, num_frames=4)
    return datasets.DatasetConfig(**kw), jdatasets.DatasetConfig(**kw)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_youtube_dataset_matches_jax(clips, ext):
    cfg, jcfg = _ds_cfgs(clips, "opendv", ext)
    port = datasets.YouTubeFramesDataset(cfg, ext=ext)
    ref = jdatasets.YouTubeFramesDataset(jcfg, ext=ext)
    assert len(port) == len(ref) == 4
    for i in range(8):
        got = port[i]
        assert got["frames"].shape == (4, SIZE, SIZE, 3)
        _assert_same(got, ref[i])


@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_nuscenes_dataset_matches_jax(clips, ext):
    cfg, jcfg = _ds_cfgs(clips, "nusc", ext)
    port, ref = datasets.NuScenesDataset(cfg), jdatasets.NuScenesDataset(jcfg)
    assert port.annos == ref.annos and len(port) > 7
    modalities = set()
    for i in range(8):
        got = port[i]
        modalities |= set(got) - {"frames", "fps_id", "motion_bucket_id", "cond_aug"}
        _assert_same(got, ref[i])
    assert port._action_mod == ref._action_mod
    assert modalities >= {"trajectory", "command"}


def test_oversampling_matches_jax(clips):
    annos = json.loads((clips / "nusc.jpg.json").read_text())
    for factor in (2, 5):
        assert datasets.balance_with_actions(annos, factor) == jdatasets.balance_with_actions(
            annos, factor)
        assert datasets.resample_complete_samples(
            annos, factor) == jdatasets.resample_complete_samples(annos, factor)
    assert [datasets._goal_valid(a) for a in annos] == [jdatasets._goal_valid(a) for a in annos]


def test_synthetic_matches_jax():
    kw = dict(height=16, width=24, num_frames=3)
    port = datasets.SyntheticVideoDataset(datasets.DatasetConfig(**kw), 5, with_actions=True)
    ref = jdatasets.SyntheticVideoDataset(jdatasets.DatasetConfig(**kw), 5, with_actions=True)
    assert len(port) == len(ref) == 5
    for i in (0, 3, 4):
        _assert_same(port[i], ref[i])


def test_pipeline_matches_jax(clips):
    """Two weighted sources, one thread, batches of 2: the first 4 batches
    (the nuScenes modalities that not every sample of a batch has dropped)."""
    src = lambda mod, kind, ext: mod.SourceConfig(
        kind=kind, anno_file=str(clips / f"{'opendv' if kind == 'youtube' else 'nusc'}{ext}.json"),
        data_root=str(clips / f"{'opendv' if kind == 'youtube' else 'nusc'}{ext}"),
        ext=ext, prob=1.0 if kind == "youtube" else 3.0)
    out = []
    for mod in (pipeline, jpipeline):
        cfg = mod.DataConfig(sources=(src(mod, "youtube", ".png"), src(mod, "nuscenes", ".png")),
                             batch_size=2, num_threads=1, prefetch=2, samples_per_epoch=8,
                             seed=5)
        pipe = mod.build_pipeline(cfg, SIZE, SIZE, 4)
        out.append(list(pipe))
        pipe.stop()
    got, ref = out
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert a["frames"].shape == (2, 4, SIZE, SIZE, 3)
        _assert_same(a, b)


class _Broken:
    def __len__(self):
        return 3

    def __getitem__(self, i):
        raise OSError("unreadable frame")


def test_retry_bound_raises():
    sampler = pipeline.MultiSourceSampler([_Broken()], samples_per_epoch=4, max_retries=3)
    with pytest.raises(RuntimeError, match="3 consecutive sample failures"):
        sampler.sample()
    assert sampler.error_count == 3


def test_worker_error_reaches_consumer():
    sampler = pipeline.MultiSourceSampler([_Broken()], samples_per_epoch=4, max_retries=2)
    pipe = pipeline.DataPipeline(sampler, pipeline.PipelineConfig(num_threads=3, prefetch=1))
    with pytest.raises(RuntimeError, match="consecutive sample failures"):
        next(iter(pipe))
    pipe.stop()
    assert not any(t.is_alive() for t in pipe._threads)


def test_stop_ends_running_workers():
    ds = datasets.SyntheticVideoDataset(datasets.DatasetConfig(height=8, width=8, num_frames=2), 4)
    pipe = pipeline.DataPipeline(pipeline.MultiSourceSampler([ds], samples_per_epoch=1000),
                                 pipeline.PipelineConfig(num_threads=4, prefetch=1))
    it = iter(pipe)
    assert next(it)["frames"].shape == (1, 2, 8, 8, 3)
    pipe.stop()
    assert not any(t.is_alive() for t in pipe._threads)


# ---------------------------------------------------------------- native

@pytest.fixture(scope="module")
def native_libs():
    """Both bindings loaded, building ``native/libvista_host.so`` first where
    it is missing (as ``tests/test_native_host.py`` does)."""
    if not native.available():
        if shutil.which("make") is None or shutil.which("g++") is None:
            pytest.skip("no native toolchain (make/g++) available")
        build = subprocess.run(["make", "-C", str(ROOT / "native")], capture_output=True,
                               text=True)
        if build.returncode != 0:
            pytest.skip(f"native build failed: {build.stderr[-500:]}")
        for mod in (native, jnative):
            mod._TRIED, mod._LIB = False, None
    if not (native.available() and jnative.available()):
        pytest.skip("libvista_host.so missing after build")
    return native, jnative


def _jpegs(rng, n, w=160, h=120):
    blobs = []
    for _ in range(n):
        buf = io.BytesIO()
        _frame(rng, w, h).save(buf, "JPEG", quality=90)
        blobs.append(buf.getvalue())
    return blobs


def test_native_binding_matches_jax(native_libs):
    port, ref = native_libs
    rng = np.random.RandomState(3)
    blobs = _jpegs(rng, 4)
    got = port.process_jpeg_batch(blobs, 48, 80, threads=2)
    np.testing.assert_array_equal(got, ref.process_jpeg_batch(blobs, 48, 80, threads=2))
    rgb = rng.randint(0, 256, (90, 160, 3), np.uint8)
    np.testing.assert_array_equal(port.crop_resize_normalize(rgb, 40, 72),
                                  ref.crop_resize_normalize(rgb, 40, 72))
    if port.encode_jpeg_available():
        assert port.encode_jpeg(rgb) == ref.encode_jpeg(rgb)
    # native against PIL: the bound test_native_host.py holds
    pil = np.stack([datasets.center_crop_resize(Image.open(io.BytesIO(b)), 48, 80)
                    for b in blobs])
    assert float(np.abs(got - pil).mean()) < 0.03
    with pytest.raises(IOError, match="decode failed"):
        port.process_jpeg_batch([b"not a jpeg"], 8, 8)


def test_missing_library_takes_pil(clips, monkeypatch):
    monkeypatch.setenv("VISTA_HOST_LIB", str(clips / "no_such_library.so"))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert not native.available()
    cfg, _ = _ds_cfgs(clips, "opendv", ".jpg")
    frames = datasets.YouTubeFramesDataset(cfg)[1]["frames"]
    paths = [str(clips / "opendv.jpg" / "video0" / f"{i:09d}.jpg") for i in range(2, 6)]
    np.testing.assert_array_equal(frames, np.stack([datasets.load_image(p, SIZE, SIZE)
                                                    for p in paths]))
