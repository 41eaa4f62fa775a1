"""The port's sample and reward CLIs, their inputs and their writers, on the
CPU:

- both CLIs end to end in-process with ``--tiny --device cpu`` (2 rounds of
  2 steps; an ensemble of 2): the files written, ``2 * (T - 3) + 3`` frames
  in the video and the frame directory, the reward's JSON line; without
  ``--device`` they run on the card and raise when there is none;
- the context frames and actions each CLI builds (seeded random frames, a
  random trajectory, an annotation in every action mode, the ``goal``
  mode's ``"z"`` guard) equal to what the JAX CLIs hand their rollout and
  reward, captured by replacing those two functions (nothing is compiled);
- the PNG frame and grid writers decode (PIL) to the same uint8 arrays as
  ``vista_tpu.utils.video`` writes; the AVI's RIFF structure parses, in
  Motion-JPEG and uncompressed.
"""

import io
import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import vista_tpu.engine
import vista_tpu.engine.reward
from vista_tpu.cli import reward as jax_reward_cli
from vista_tpu.cli import sample as jax_sample_cli
from vista_tpu.engine.engine import VistaEngine as JVistaEngine
from vista_tpu.utils import video as jax_video
from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch.cli import reward as reward_cli
from vista_tpu_torch.cli import sample as sample_cli
from vista_tpu_torch.cli._common import build_engine
from vista_tpu_torch.utils import video

T = 4  # the tiny engine's frames


def parse_avi(data: bytes) -> dict:
    """The RIFF tree of an AVI: the main and stream headers, and the movi
    chunks and index entries in order."""
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    out = {"chunks": [], "index": []}

    def walk(pos, end):
        while pos < end:
            fourcc, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if fourcc == b"LIST":
                kind = data[body:body + 4]
                if kind == b"movi":
                    out["movi_start"] = body
                walk(body + 4, body + size)
                if kind == b"movi":
                    out["movi_end"] = body + size
            elif fourcc == b"avih":
                f = struct.unpack("<14I", data[body:body + 56])
                out["avih"] = dict(us_per_frame=f[0], frames=f[4], width=f[8], height=f[9])
            elif fourcc == b"strh":
                out["strh"] = dict(type=data[body:body + 4], handler=data[body + 4:body + 8],
                                   rate=struct.unpack("<I", data[body + 24:body + 28])[0],
                                   length=struct.unpack("<I", data[body + 32:body + 36])[0])
            elif fourcc == b"strf":
                f = struct.unpack("<IiiHH4sIiiII", data[body:body + 40])
                out["strf"] = dict(width=f[1], height=f[2], bits=f[4], compression=f[5],
                                   image_bytes=f[6])
            elif fourcc in (b"00dc", b"00db"):
                out["chunks"].append((fourcc, pos, data[body:body + size]))
            elif fourcc == b"idx1":
                for i in range(body, body + size, 16):
                    out["index"].append((data[i:i + 4], *struct.unpack("<III", data[i + 4:i + 16])))
            pos = body + size + (size % 2)

    walk(12, len(data))
    return out


def _avi_frames(path):
    with open(path, "rb") as f:
        return parse_avi(f.read())["avih"]["frames"]


def test_sample_cli_end_to_end(tmp_path, capsys):
    save = tmp_path / "out"
    out = sample_cli.run(*_args(sample_cli, ["--tiny", "--device", "cpu", "--n_rounds", "2",
                                             "--n_steps", "2", "--action", "traj",
                                             "--save", str(save)]))
    n = 2 * (T - 3) + 3
    assert out["latents"].shape[0] == n and out["pixels"].shape == (n, 3, 32, 32)
    assert bool(torch.isfinite(out["pixels"]).all())
    assert sorted(os.listdir(save)) == ["grids", "images", "videos", "videos_real"]
    assert len(os.listdir(save / "images")) == n
    assert _avi_frames(out["paths"]["video"]) == n
    assert _avi_frames(out["paths"]["real"]) == T
    grid = np.asarray(Image.open(out["paths"]["grid"]))
    assert grid.shape == (2 * 34 - 2, 3 * 34 - 2, 3)  # 5 frames, 3 a row, padding 2
    printed = capsys.readouterr().out
    for path in (out["paths"]["video"], out["paths"]["grid"], out["paths"]["real"]):
        assert f"wrote {path}" in printed


def test_reward_cli_end_to_end(tmp_path, capsys):
    reward_cli.main(["--tiny", "--device", "cpu", "--n_steps", "2", "--ens_size", "2",
                     "--save", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"sample_index", "reward"} and line["sample_index"] == 0
    assert 0.0 < line["reward"] <= 1.0
    assert _avi_frames(tmp_path / "real" / "videos" / "reward_000000.avi") == T
    assert os.listdir(tmp_path / "real" / "grids") == ["reward_000000.png"]


@pytest.mark.parametrize("cli", [sample_cli, reward_cli])
def test_cli_runs_on_the_card_by_default(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.parse_args(["--tiny"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="card"):
        cli.main(["--tiny", "--n_steps", "1"])


def _args(cli, argv):
    """Parsed arguments and the tiny CPU engine for them."""
    args = cli.parse_args(argv)
    return args, build_engine(args)


class _Captured(Exception):
    pass


def _jax_sample_inputs(monkeypatch, argv):
    """What the JAX sample CLI hands its rollout: the context frames and the
    conditioning batch (the rollout is replaced, nothing is compiled)."""
    seen = {}

    def capture(engine, params, images, batch, *a, **k):
        seen.update(images=np.asarray(images), batch={k: np.asarray(v) for k, v in batch.items()})
        raise _Captured

    monkeypatch.setattr(vista_tpu.engine, "autoregressive_rollout", capture)
    monkeypatch.setattr(JVistaEngine, "init_params", lambda *a, **k: {})
    with pytest.raises(_Captured):
        jax_sample_cli.main(argv)
    return seen


def _jax_reward_inputs(monkeypatch, argv):
    seen = {}

    def capture(engine, params, images, batch, *a, **k):
        seen.update(images=np.asarray(images), batch={k: np.asarray(v) for k, v in batch.items()})
        return 0.5

    monkeypatch.setattr(vista_tpu.engine.reward, "estimate_reward", capture)
    monkeypatch.setattr(JVistaEngine, "init_params", lambda *a, **k: {})
    jax_reward_cli.main(argv)
    return seen


def _port_batch(out):
    return {k: v.cpu().numpy() for k, v in out["batch"].items()}


@pytest.fixture(scope="module")
def tiny_engine():
    return _args(sample_cli, ["--tiny", "--device", "cpu", "--action", "traj"])[1]


@pytest.mark.parametrize("seed", [0, 23])
def test_random_context_matches_the_jax_cli(seed, monkeypatch, tmp_path):
    argv = ["--tiny", "--seed", str(seed), "--height", "48", "--width", "80"]
    ref = _jax_sample_inputs(monkeypatch, argv + ["--save", str(tmp_path / "jax")])
    args = sample_cli.parse_args(argv)
    frames, actions = sample_cli.context(args)
    assert frames.shape == (T, 32, 32, 3) and not actions
    np.testing.assert_array_equal(frames, ref["images"])


def test_reward_random_inputs_match_the_jax_cli(monkeypatch, tiny_engine, capsys):
    argv = ["--tiny", "--seed", "5", "--n_steps", "1", "--ens_size", "2"]
    ref = _jax_reward_inputs(monkeypatch, argv)
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = reward_cli.run(reward_cli.parse_args(argv + ["--device", "cpu"]), tiny_engine)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(jax_line) and line["sample_index"] == jax_line["sample_index"]
    np.testing.assert_array_equal(out["images"].permute(0, 2, 3, 1).numpy(), ref["images"])
    got = _port_batch(out)
    assert set(got) == set(ref["batch"])
    for k in got:
        np.testing.assert_array_equal(got[k], ref["batch"][k].astype(np.float32), err_msg=k)


ANNO = {"traj": [float(i) * 1.5 - 4.0 for i in range(12)], "cmd": 2,
        "speed": [3.0, 4.5, 5.25, 6.0, 7.5, 8.0], "angle": [10.0, -20.0, 33.0, 41.0, 52.0, 60.0],
        "goal": [812.0, 455.0], "z": 1.2}


@pytest.fixture(scope="module")
def anno_dir(tmp_path_factory):
    """An annotation file of two samples (the second without ``"z"``) over
    T frames of 40x60 RGB PNGs."""
    root = tmp_path_factory.mktemp("anno")
    rng = np.random.default_rng(3)
    names = []
    for i in range(T + 1):
        names.append(f"frames/f{i}.png")
        os.makedirs(root / "frames", exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)).save(root / names[-1])
    no_z = {k: v for k, v in ANNO.items() if k != "z"}
    with open(root / "anno.json", "w") as f:
        json.dump([dict(ANNO, frames=names), dict(no_z, frames=names[1:])], f)
    return root


@pytest.mark.parametrize("action,index", [("free", 0), ("traj", 0), ("cmd", 0), ("steer", 0),
                                          ("goal", 0), ("goal", 1)])
def test_annotation_reader_matches_the_jax_cli(action, index, anno_dir, monkeypatch, tmp_path):
    argv = ["--tiny", "--anno", str(anno_dir / "anno.json"), "--data-root", str(anno_dir),
            "--action", action, "--sample_index", str(index)]
    ref = _jax_sample_inputs(monkeypatch, argv + ["--save", str(tmp_path)])
    frames, actions = sample_cli.context(sample_cli.parse_args(argv))
    np.testing.assert_array_equal(frames, ref["images"])
    scalars = {"fps_id", "motion_bucket_id", "cond_aug"}
    assert set(actions) == set(ref["batch"]) - scalars
    for k, v in actions.items():
        assert v.dtype == np.float32 and v.shape == ref["batch"][k].shape
        np.testing.assert_array_equal(v, ref["batch"][k], err_msg=k)
    expected = {"free": set(), "traj": {"trajectory"}, "cmd": {"command"},
                "steer": {"speed", "angle"}, "goal": {"goal"} if index == 0 else set()}
    assert set(actions) == expected[action]  # the goal mode needs "z" in the annotation


def test_reward_annotation_matches_the_jax_cli(anno_dir, monkeypatch, tiny_engine, capsys):
    argv = ["--tiny", "--anno", str(anno_dir / "anno.json"), "--data-root", str(anno_dir),
            "--n_steps", "1", "--ens_size", "2"]
    ref = _jax_reward_inputs(monkeypatch, argv)
    out = reward_cli.run(reward_cli.parse_args(argv + ["--device", "cpu"]), tiny_engine)
    np.testing.assert_array_equal(out["images"].permute(0, 2, 3, 1).numpy(), ref["images"])
    got = _port_batch(out)
    assert set(got) == set(ref["batch"])
    np.testing.assert_array_equal(got["trajectory"], ref["batch"]["trajectory"])


def _frames(seed, n=5, h=12, w=20, real=False):
    rng = np.random.default_rng(seed)
    lo = -1.2 if real else -0.1  # a little outside the range: the writers clip
    return rng.uniform(lo, 1.1, (n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("real", [False, True])
def test_png_writers_match_jax(real, tmp_path):
    frames = _frames(1, real=real)
    ours = video.save_frames_png(str(tmp_path / "ours"), frames, prefix="s", real=real)
    jax_video.save_frames_png(str(tmp_path / "jax"), frames, prefix="s", real=real)
    assert [os.path.basename(p) for p in ours] == sorted(os.listdir(tmp_path / "jax"))
    for p in ours:
        ref = tmp_path / "jax" / os.path.basename(p)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(ref)))
    for nrow in (None, 2):
        g = video.save_grid_png(str(tmp_path / f"g{nrow}.png"), frames, nrow=nrow, real=real)
        jax_video.save_grid_png(str(tmp_path / f"j{nrow}.png"), frames, nrow=nrow, real=real)
        np.testing.assert_array_equal(np.asarray(Image.open(g)),
                                      np.asarray(Image.open(tmp_path / f"j{nrow}.png")))


def _check_avi(path, n, h, w, handler, kind):
    with open(path, "rb") as f:
        data = f.read()
    avi = parse_avi(data)
    assert avi["avih"] == dict(us_per_frame=100_000, frames=n, width=w, height=h)
    assert avi["strh"] == dict(type=b"vids", handler=handler, rate=10, length=n)
    assert (avi["strf"]["width"], avi["strf"]["height"], avi["strf"]["bits"]) == (w, h, 24)
    assert [c[0] for c in avi["chunks"]] == [kind] * n
    assert len(avi["index"]) == n
    for (fourcc, flags, offset, size), (_, pos, payload) in zip(avi["index"], avi["chunks"]):
        assert fourcc == kind and flags == 0x10 and size == len(payload)
        assert avi["movi_start"] + offset == pos  # offsets count from the 'movi' fourcc
    return avi


def test_avi_motion_jpeg_parses(tmp_path):
    # smooth frames (ramps), which JPEG keeps within a few levels
    y, x = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 24), indexing="ij")
    frames = np.stack([np.stack([x, y, np.full_like(x, i / 3)], -1) for i in range(3)])
    path = video.save_video_avi_mjpeg(str(tmp_path / "v.avi"), frames)
    avi = _check_avi(path, 3, 16, 24, b"MJPG", b"00dc")
    assert avi["strf"]["compression"] == b"MJPG"
    ref_path = jax_video.save_video_avi_mjpeg(str(tmp_path / "j.avi"), frames)
    ref = parse_avi(open(ref_path, "rb").read())
    assert (ref["avih"], ref["strh"]["handler"], len(ref["chunks"])) == (
        avi["avih"], b"MJPG", 3)
    for (_, _, payload), f in zip(avi["chunks"], video._to_uint8(frames)):
        got = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
        assert got.shape == f.shape and np.abs(got.astype(int) - f).mean() < 4


def test_avi_uncompressed_parses_without_a_jpeg_encoder(tmp_path, monkeypatch):
    monkeypatch.setattr(video, "_encode_jpeg", lambda frame, quality: None)
    frames = _frames(3, n=4, h=6, w=7, real=True)  # 21-byte rows: padded to 24
    path = video.save_video_mp4(str(tmp_path / "v.mp4"), frames, real=True)
    assert path.endswith(".avi")
    avi = _check_avi(path, 4, 6, 7, b"DIB ", b"00db")
    assert avi["strf"]["compression"] == b"\0\0\0\0" and avi["strf"]["image_bytes"] == 24 * 6
    for (_, _, payload), f in zip(avi["chunks"], video._to_uint8(frames, real=True)):
        rows = np.frombuffer(payload, np.uint8).reshape(6, 24)[:, :21].reshape(6, 7, 3)
        np.testing.assert_array_equal(rows[::-1, :, ::-1], f)
