"""The port's evaluation and tooling against the JAX package, on the CPU in
fp32, inputs made with numpy from a seed:

- the CLIP text tower: a seeded HF-layout state dict fed to JAX through
  ``import_hf_clip_text`` and to the port with no map, hidden states and
  the EOT-pooled output within 1e-5 of the largest magnitude (the dict has
  the ``text_model.`` prefix and the ``position_ids`` buffer that HF
  checkpoints carry);
- ``utils/metrics.py`` against ``vista_tpu.utils.metrics``: feature
  statistics, the PSD square root, the Fréchet distances, PSNR and SSIM
  (numpy and torch inputs) within 1e-12 relative, and every corruption bit
  for bit;
- the counterpart of ``test_quality_calibration.py`` with the port's tiny
  tower: the same clips (equal to the JAX test's), FCD rising over the
  noise and blur grades while PSNR falls, shuffle's FCD far below them;
- ``StepTimer.report()``'s keys, and a ``span`` showing in a profiler's
  Chrome trace;
- ``tools/torch_quality_bench.py --smoke --device cpu`` in-process (the JAX
  harness's payload keys, finite metrics), its calibration, and its
  synthetic clips against the JAX harness's construction.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu.models import clip as jclip
from vista_tpu.utils import metrics as jm
from vista_tpu.utils import torch_import as ti
from vista_tpu_torch.models import clip
from vista_tpu_torch.utils import metrics as m
from vista_tpu_torch.utils import profiling
from vista_tpu_torch.utils.profiling import StepTimer, span

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def hf_text_state(cfg, seed=0):
    """A seeded state dict in HF ``CLIPTextModel``'s layout and names."""
    rng = np.random.default_rng(seed)
    w, v, L = cfg.width, cfg.vocab_size, cfg.max_length
    lin = lambda o, i: (rng.standard_normal((o, i)) * i ** -0.5).astype(np.float32)
    vec = lambda n, c=0.0: (c + 0.1 * rng.standard_normal(n)).astype(np.float32)
    sd = {"text_model.embeddings.token_embedding.weight": vec((v, w)) * 10,
          "text_model.embeddings.position_embedding.weight": vec((L, w)),
          "text_model.final_layer_norm.weight": vec(w, 1.0),
          "text_model.final_layer_norm.bias": vec(w)}
    for i in range(cfg.layers):
        h = f"text_model.encoder.layers.{i}."
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[h + f"self_attn.{p}.weight"], sd[h + f"self_attn.{p}.bias"] = lin(w, w), vec(w)
        for n in ("layer_norm1", "layer_norm2"):
            sd[h + f"{n}.weight"], sd[h + f"{n}.bias"] = vec(w, 1.0), vec(w)
        sd[h + "mlp.fc1.weight"], sd[h + "mlp.fc1.bias"] = lin(4 * w, w), vec(4 * w)
        sd[h + "mlp.fc2.weight"], sd[h + "mlp.fc2.bias"] = lin(w, 4 * w), vec(w)
    return sd


def tokens_for(cfg, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, cfg.vocab_size - 1, (2, cfg.max_length))
    tokens[0, 5] = tokens[1, 11] = cfg.vocab_size - 1  # EOT, the largest id
    return tokens


def test_text_tower_matches_jax():
    jcfg = jclip.CLIPTextConfig(dtype="float32").tiny()
    cfg = clip.CLIPTextConfig(dtype="float32").tiny()
    sd = hf_text_state(cfg)
    tokens = tokens_for(cfg)
    params = {"params": ti.import_hf_clip_text(sd, jcfg)}
    sd["text_model.embeddings.position_ids"] = np.arange(cfg.max_length)[None]
    ref_h, ref_p = jclip.CLIPTextTower(jcfg).apply(params, jnp.asarray(tokens))
    tower = clip.CLIPTextTower(cfg)
    clip.load_hf_clip_text(tower, sd)
    with torch.no_grad():
        h, p = tower(torch.from_numpy(tokens))
    assert h.shape == (2, cfg.max_length, cfg.width) and p.shape == (2, cfg.width)
    assert _rel(h.numpy(), ref_h) <= TOL and _rel(p.numpy(), ref_p) <= TOL
    assert np.array_equal(p.numpy(), h.numpy()[[0, 1], [5, 11]])


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((40, 6))
    b = rng.standard_normal((30, 6)) * 1.3 + 0.2
    for got, ref in zip(m.feature_stats(a), jm.feature_stats(a)):
        assert np.array_equal(got, ref)
    s = np.cov(a, rowvar=False)
    assert _rel(m.sqrtm_psd(s), jm._sqrtm_psd(s)) <= 1e-12
    assert m.frechet_feature_distance(a, b) == pytest.approx(
        jm.frechet_feature_distance(a, b), rel=1e-12)
    assert m.frechet_distance(*jm.feature_stats(a), *jm.feature_stats(b)) == pytest.approx(
        jm.frechet_distance(*jm.feature_stats(a), *jm.feature_stats(b)), rel=1e-12)
    x = rng.uniform(-1, 1, (3, 24, 20, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1, 1).astype(np.float32)
    for fn, jfn in ((m.psnr, jm.psnr), (m.ssim, jm.ssim)):
        ref = jfn(x, y)
        assert fn(x, y) == pytest.approx(ref, rel=1e-12)
        assert fn(torch.from_numpy(x), torch.from_numpy(y)) == pytest.approx(ref, rel=1e-12)
        assert fn(x[0], y[0]) == pytest.approx(jfn(x[0], y[0]), rel=1e-12)
    assert m.psnr(x, x) == jm.psnr(x, x) == float("inf")
    for kind in ("noise", "blur", "shuffle"):
        for s in (0.0, 0.15, 0.8):
            got = m.corrupt_clip(x, kind, s, np.random.RandomState(3))
            assert np.array_equal(got, jm.corrupt_clip(x, kind, s, np.random.RandomState(3)))
    with pytest.raises(ValueError):
        m.corrupt_clip(x, "jpeg", 0.5, np.random.RandomState(0))


def test_fcd_sensitivity_calibration():
    """The port's tiny tower (its own initialisation) grades the JAX test's
    clips as the JAX one does."""
    from tests.test_quality_calibration import GRADES, H, T, W, _clips

    rng = np.random.RandomState(0)
    wh, ww = (clip.resize_weights(n // 4, n, "linear") for n in (H, W))
    clips = []
    for _ in range(3):
        base = (rng.randn(H // 4, W // 4, 3) * 0.5).astype(np.float32)
        big = np.einsum("abc,ah,bw->hwc", base, wh, ww, optimize=True)
        clips.append(np.clip(np.stack([np.roll(big, 2 * i, axis=1) for i in range(T)]),
                             -1, 1).astype(np.float32))
    for got, ref in zip(clips, _clips()):
        assert _rel(got, ref) <= 1e-6
    torch.manual_seed(0)
    cfg = clip.CLIPVisionConfig(dtype="float32").tiny()
    tower = clip.CLIPVisionTower(cfg).eval()

    def feats(c):
        with torch.no_grad():
            x = torch.from_numpy(c).permute(0, 3, 1, 2)
            return tower(clip.clip_preprocess(x, cfg.image_size)).numpy()

    real = np.concatenate([feats(c) for c in clips])
    fcd, psnrs = {}, {}
    for kind in ("noise", "blur", "shuffle"):
        fcd[kind], psnrs[kind] = [], []
        for s in GRADES:
            rng = np.random.RandomState(1000 + int(s * 100))
            cor = [m.corrupt_clip(c, kind, s, rng) for c in clips]
            fcd[kind].append(m.frechet_feature_distance(real, np.concatenate(
                [feats(c) for c in cor])))
            psnrs[kind].append(np.mean([m.psnr(a, b) for a, b in zip(cor, clips)]))
    for kind in ("noise", "blur"):
        assert all(b > a for a, b in zip(fcd[kind], fcd[kind][1:])), (kind, fcd[kind])
        assert all(b < a for a, b in zip(psnrs[kind], psnrs[kind][1:])), (kind, psnrs[kind])
    assert max(fcd["shuffle"]) < 0.5 * min(fcd["noise"] + fcd["blur"]), fcd
    assert psnrs["shuffle"][-1] < psnrs["shuffle"][0], psnrs["shuffle"]
    s_noise = np.mean([m.ssim(m.corrupt_clip(c, "noise", 0.8, np.random.RandomState(1)), c)
                       for c in clips])
    assert s_noise < 0.9


def test_step_timer_and_trace(tmp_path):
    timer = StepTimer()
    assert timer.report() == {}
    for _ in range(3):
        with timer.step() as out:
            with span("vista_matmul"):
                out["result"] = torch.ones(8, 8) @ torch.ones(8, 8)
    timer.start()
    timer.stop(torch.zeros(1))
    report = timer.report()
    assert set(report) == {"steps", "p50_s", "p90_s", "mean_s", "steps_per_sec"}
    assert report["steps"] == 4 and report["steps_per_sec"] > 0
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("vista_region"):
            torch.ones(4).sum()
    assert [s.name for s in profiling.spans()] == ["vista_region"]
    profiling.clear()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    text = (tmp_path / "trace.json").read_text()
    assert "vista_region" in text and json.loads(text)["traceEvents"]


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("torch_quality_bench",
                                                  ROOT / "tools" / "torch_quality_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quality_bench_smoke(bench, tmp_path):
    out = tmp_path / "q.json"
    payload = bench.main(["--smoke", "--device", "cpu", "--n_steps", "2", "--out", str(out)])
    assert json.loads(out.read_text()) == payload
    assert {"metric", "frechet_clip_distance", "psnr_db", "ssim", "config", "note"} <= set(payload)
    assert set(payload["config"]) == {"height", "width", "frames", "n_clips", "n_steps",
                                      "cfg_scale", "seed", "weights", "clips", "backend"}
    assert payload["config"]["backend"] == "cpu" and payload["config"]["n_clips"] == 2
    assert all(np.isfinite(payload[k]) for k in ("frechet_clip_distance", "psnr_db", "ssim"))
    cal = bench.main(["--smoke", "--calibrate", "--device", "cpu"])
    assert cal["validated"] and set(cal["calibration"]) == {"noise", "blur", "shuffle"}
    with pytest.raises(SystemExit):
        bench.main(["--smoke"])  # the card by default, and there is none here


def test_quality_bench_clips_match_jax_harness(bench):
    h, w, t = 32, 48, 3
    got = bench.synthetic_clips(2, t, h, w, 5)
    rng = np.random.RandomState(5)
    for clip_ in got:
        base = rng.randn(h // 8, w // 8, 3) * 0.5
        big = np.asarray(jax.image.resize(jnp.asarray(base), (h, w, 3), "linear"))
        ref = np.clip(np.stack([np.roll(big, 2 * i, axis=1) for i in range(t)]), -1, 1)
        assert _rel(clip_, ref) <= 1e-6
