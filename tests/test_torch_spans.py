"""The port's spans and its one way to the host
(``vista_tpu_torch/utils/profiling.py``), on the CPU with a tiny fp32
engine:

- with no profiler recording nothing is stored, no ``RecordFunction`` is
  opened and nothing synchronises (both patched to fail);
- under ``torch.profiler``: parents, request ids and per-thread nesting, and
  every span within 2 ms of its ``RecordFunction`` twin in the profiler's
  events (the spans are stamped on the clock of the profiler's host events),
  a host-side op, not a user annotation (which the trace would copy onto
  the device's row);
- a two-round ``autoregressive_rollout`` gives one ``rollout`` holding
  ``encode``, two ``condition`` a round (``condition.encode`` in round 1
  only, ``skip_encode`` after), a ``sample`` a round with ``num_steps``
  ``sampler.step``, and ``decode`` / ``decode.window``;
- two micro-steps of a ``Trainer`` at ``accum_steps`` 2 make
  ``2 * (1 + 1 + metrics) + 1`` ``host_sync`` spans: per micro-step the
  gradient norm, the loss and each loss metric, plus the accumulated norm;
- the outputs are bit for bit the same with and without a profiler.
"""

import collections
import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.torch_threads import one_thread  # noqa: F401
from vista_tpu_torch.diffusion.guidance import GuiderConfig
from vista_tpu_torch.diffusion.loss import LossConfig
from vista_tpu_torch.diffusion.sampler import SamplerConfig
from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine
from vista_tpu_torch.engine.rollout import (RolloutConfig, autoregressive_rollout,
                                            draw_rollout_noise)
from vista_tpu_torch.engine.training import TrainConfig, Trainer, draw_train
from vista_tpu_torch.utils import profiling

ROUNDS, STEPS, SIZE = 2, 2, 32
CLOCK_NS = 2_000_000


def _engine():
    cfg = EngineConfig().tiny()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dtype="float32"),
                              vae=dataclasses.replace(cfg.vae, dtype="float32"))
    torch.manual_seed(0)
    return VistaEngine(cfg, "cpu")


def _rollout(engine, start):
    engine.unet.load_state_dict(start)
    gen = torch.Generator().manual_seed(1)
    t = engine.cfg.num_frames
    images = torch.randn(t, 3, SIZE, SIZE, generator=gen) * 0.2
    batch = {"fps_id": torch.tensor([9.0]), "motion_bucket_id": torch.tensor([127.0]),
             "cond_aug": torch.tensor([0.0])}
    draws = draw_rollout_noise(engine, images, ROUNDS, gen)
    sampler = SamplerConfig(num_steps=STEPS, guider=GuiderConfig(kind="vanilla", scale=2.5,
                                                                 num_frames=t))
    return autoregressive_rollout(engine, images, batch, sampler,
                                  RolloutConfig(num_rounds=ROUNDS), draws)


def _train(engine, start):
    """Two micro-steps (one optimizer step) from the UNet's ``start``."""
    engine.unet.load_state_dict(start)
    t = engine.cfg.num_frames
    cfg = TrainConfig(accum_steps=2, policy="slow_spatial", learning_rate=1e-3,
                      warmup_steps=0, loss=LossConfig(num_frames=t, use_additional_loss=True))
    trainer = Trainer(engine, cfg)
    gen = torch.Generator().manual_seed(2)
    metrics = []
    for _ in range(2):
        batch = {"frames": torch.rand(1, t, 3, SIZE, SIZE, generator=gen) * 2 - 1,
                 "fps_id": torch.tensor([9.0]), "motion_bucket_id": torch.tensor([127.0]),
                 "cond_aug": torch.tensor([0.02])}
        metrics.append(trainer(batch, draw_train(engine, cfg, batch, gen)))
    return metrics, {n: m.clone() for n, m in trainer.master.items()}


@pytest.fixture(scope="module")
def runs(one_thread):  # noqa: F811
    engine = _engine()
    start = {k: v.clone() for k, v in engine.unet.state_dict().items()}
    out = {}
    profiling.clear()
    with pytest.MonkeyPatch.context() as mp:
        def refuse(*args, **kwargs):
            raise AssertionError("entered with no profiler recording")

        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        mp.setattr(torch.cuda, "synchronize", refuse)
        out["off"] = (_rollout(engine, start), _train(engine, start))
    out["stored_off"] = profiling.spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rollout = _rollout(engine, start)
        split = len(profiling.spans())
        train = _train(engine, start)
    out["on"] = (rollout, train)
    stored = profiling.spans()
    out["rollout_spans"], out["train_spans"] = stored[:split], stored[split:]
    out["events"] = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.is_user_annotation()) for e in prof.profiler.kineto_results.events()]
    out["engine"] = engine
    profiling.clear()
    return out


def test_nothing_is_stored_or_opened_without_a_profiler(runs):
    assert runs["stored_off"] == []
    assert profiling.span("anything") is profiling.span("else")


def test_outputs_are_bit_identical_with_and_without_a_profiler(runs):
    (pixels_off, latents_off), (metrics_off, master_off) = runs["off"]
    (pixels_on, latents_on), (metrics_on, master_on) = runs["on"]
    assert torch.equal(pixels_off, pixels_on) and torch.equal(latents_off, latents_on)
    assert metrics_off == metrics_on
    assert master_off.keys() == master_on.keys()
    assert all(torch.equal(master_off[n], master_on[n]) for n in master_off)


def test_a_two_round_rollout_gives_its_spans(runs):
    spans = runs["rollout_spans"]
    cfg = runs["engine"].cfg
    counts = collections.Counter(s.name for s in spans)
    windows = len(range(cfg.decode_overlap, cfg.num_frames, cfg.decode_chunk - cfg.decode_overlap))
    assert counts == {"rollout": 1, "encode": 1, "condition": 2 * ROUNDS,
                      "condition.clip": 2 * ROUNDS, "condition.encode": 2, "sample": ROUNDS,
                      "sampler.step": ROUNDS * STEPS, "decode": ROUNDS,
                      "decode.window": ROUNDS * windows}
    by_index = {s.index: s for s in spans}
    root = spans[0]
    assert root.name == "rollout" and root.parent is None
    assert all(s.request == root.request for s in spans)
    parents = {"encode": "rollout", "condition": "rollout", "sample": "rollout",
               "decode": "rollout", "condition.clip": "condition",
               "condition.encode": "condition", "sampler.step": "sample",
               "decode.window": "decode"}
    for s in spans[1:]:
        assert by_index[s.parent].name == parents[s.name]
        assert by_index[s.parent].start_ns <= s.start_ns <= s.end_ns <= by_index[s.parent].end_ns
    # condition.encode in round 1 only: both of its conditions come before the first sample
    first_sample = next(s.start_ns for s in spans if s.name == "sample")
    assert all(s.end_ns < first_sample for s in spans if s.name == "condition.encode")


def test_the_trainer_counts_its_host_syncs(runs):
    spans = runs["train_spans"]
    metrics = runs["on"][1][0]
    n_metrics = len(metrics[0]) - 2  # besides the loss and the gradient norm
    assert n_metrics == 3
    counts = collections.Counter(s.name for s in spans)
    assert counts["host_sync"] == 2 * (1 + 1 + n_metrics) + 1
    assert counts["train.step"] == 2 and counts["apply.norm"] == 3
    assert counts["apply.update"] == 1 and counts["apply.ema"] == 2
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["train.step", "train.step"]
    assert roots[0].request != roots[1].request
    by_index = {s.index: s for s in spans}
    for s in spans:
        if s.name in ("train.forward", "train.backward", "train.apply"):
            assert by_index[s.parent].name == "train.step"
        if s.name.startswith("apply."):
            assert by_index[s.parent].name == "train.apply"


def test_spans_lie_on_the_profilers_clock(runs):
    events = collections.defaultdict(list)
    for name, start, end, annotation in runs["events"]:
        events[name].append((start, end, annotation))
    spans = runs["rollout_spans"] + runs["train_spans"]
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append((s.start_ns, s.end_ns))
    for name, mine in by_name.items():
        twins = sorted(events[name])
        assert len(twins) == len(mine), name
        for (s, e), (ts, te, annotation) in zip(sorted(mine), twins):
            assert abs(s - ts) <= CLOCK_NS and abs(e - te) <= CLOCK_NS, (name, s - ts, e - te)
            assert not annotation, name


def test_parents_and_requests_are_per_thread():
    profiling.clear()
    both_open = threading.Barrier(2)

    def work(tag):
        with profiling.span(f"outer.{tag}"):
            both_open.wait(timeout=10)
            with profiling.span(f"inner.{tag}"):
                pass

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("main"):
            threads = [threading.Thread(target=work, args=(k,)) for k in "ab"]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
    spans = {s.name: s for s in profiling.spans()}
    profiling.clear()
    assert len(spans) == 5
    for tag in "ab":
        outer, inner = spans[f"outer.{tag}"], spans[f"inner.{tag}"]
        assert outer.parent is None and inner.parent == outer.index
        assert inner.request == outer.request
    requests = {spans[n].request for n in ("main", "outer.a", "outer.b")}
    assert len(requests) == 3
