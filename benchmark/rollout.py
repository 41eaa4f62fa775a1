"""The rollout driver: requests to ``autoregressive_rollout`` one at a time
(one client, a closed loop), as ``python -m vista_tpu_torch.cli.sample``
runs them, without writing files.

A traffic file names this driver and gives ``rounds``, ``steps``, the EDM
schedule's ``sigma_min``, ``sigma_max`` and ``rho``, ``guider``
(``vanilla`` / ``linear`` / ``triangle``), ``cfg_scale``, ``min_scale``,
``n_conds`` (frames pinned in the first round), ``n_context`` (frames
re-pinned in every later one), ``cond_aug``, ``action`` (``traj`` or
``free``) and ``trace_units`` (requests in a traced run). Each request's
inputs come from the run's seed and its index: 25 context frames (as the
CLI's seeded random frames, normal with std 0.2), a trajectory of four
waypoints, and the encoder's, ``cond_aug``'s and each round's noise.

The check follows the system step by step from its own state (a whole
trajectory in fp32 would outlast the window): for the window's first
request, the reference works out again from the same inputs the
conditioning of every round and the encoder's latents; in one round drawn
from the seed, the sigmas, the state entering the round, and three Euler
steps (the first, the last and one drawn between), each from the state the
system held before it; and that round's decoder windows from the latents
the system decoded.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from benchmark import counts, harness, trace, weights
from benchmark.reference import Reference
from benchmark.reference.diffusion import edm_sigmas, euler, frame_scales, initial_state
from benchmark.reference.nn import no_tf32, precision

CHECKS = ("cond", "latent", "sigma", "init", "step", "decode")


def inputs(dev, cfg: dict, traffic: dict, seed: int):
    """One request's context frames, conditioning batch and draws on ``dev``."""
    from vista_tpu_torch.engine.rollout import RolloutDraws

    gen = torch.Generator(device=dev).manual_seed(seed)
    t, hh, ww = cfg["engine"]["num_frames"], cfg["height"], cfg["width"]
    f, zc = counts.downsample(cfg), cfg["engine"]["vae"]["z_channels"]
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    images = rnd(t, 3, hh, ww) * 0.2
    batch = {"fps_id": torch.tensor([9.0], device=dev),
             "motion_bucket_id": torch.tensor([127.0], device=dev),
             "cond_aug": torch.tensor([traffic["cond_aug"]], device=dev)}
    if traffic["action"] == "traj":  # four (lateral, forward) waypoints in metres, 0.5 s apart
        speed = torch.rand(1, generator=gen, device=dev) * 15.0
        k = torch.arange(1, 5, device=dev, dtype=torch.float32)
        lateral = rnd(4) * 0.5 * k
        batch["trajectory"] = torch.stack([lateral, speed * 0.5 * k], dim=1).reshape(1, 8)
    lat = (t, zc, hh // f, ww // f)
    draws = RolloutDraws(posterior=rnd(*lat), cond_aug=rnd(1, 3, hh, ww),
                         noise=rnd(traffic["rounds"], *lat))
    return images, batch, draws


def configs(cfg: dict, traffic: dict, steps: int):
    from vista_tpu_torch.diffusion.guidance import GuiderConfig
    from vista_tpu_torch.diffusion.sampler import SamplerConfig
    from vista_tpu_torch.engine.rollout import RolloutConfig

    guider = GuiderConfig(kind=traffic["guider"], scale=traffic["cfg_scale"],
                          min_scale=traffic["min_scale"], num_frames=cfg["engine"]["num_frames"])
    return (SamplerConfig(num_steps=steps, sigma_min=traffic["sigma_min"],
                          sigma_max=traffic["sigma_max"], rho=traffic["rho"], guider=guider),
            RolloutConfig(num_rounds=traffic["rounds"], n_context_frames=traffic["n_context"],
                          initial_cond_indices=tuple(range(traffic["n_conds"]))))


class Recorder:
    """Wraps the engine's methods on the instance once each: every wrapper
    opens the benchmark's span of that method (``spans``) and, while armed,
    keeps on the host what the timed path produced for the window's first
    request, which every window finishes: the encoder's latents, every
    round's conditioning batch and (c, uc), every round's sampled latents,
    the state entering each planned step of the planned round and the one
    after it, with its sigma, and the planned round's decoder windows. The
    round and the steps are drawn from the seed before the window.

    A record is a copy into a host buffer (pinned beside a card), queued
    behind the work that makes it: the records take no device memory and
    the host does not wait. The buffers come from a pool that the armed
    warm-up fills (:meth:`release`), so the window allocates none."""

    def __init__(self, engine, cfg: dict, traffic: dict, seed: int, spans: trace.Spans):
        rng = np.random.default_rng(seed)
        s = traffic["steps"]
        self.round = int(rng.integers(traffic["rounds"]))
        self.steps = sorted({0, s - 1, int(rng.integers(1, s - 1)) if s > 2 else 0})
        self.states = set(self.steps) | {i + 1 for i in self.steps if i + 1 < s}
        self.spans, self.armed, self.kept, self.cur = spans, False, None, None
        self.pool, self.held = {}, []
        self._wrap(engine)

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        key = (tuple(t.shape), t.dtype, t.is_cuda)
        free = self.pool.get(key)
        buf = free.pop() if free else torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        self.held.append((key, buf))
        return buf.copy_(t.detach(), non_blocking=True)

    def release(self):
        """Drop the record (the warm-up's) and pool its buffers, with one more
        of the state's and its sigma's for every planned state it did not
        reach. The caller has waited for the copies."""
        extra = len(self.states) - len(self.kept["states"]) if self.kept else 0
        for key, buf in self.held:
            self.pool.setdefault(key, []).append(buf)
        if self.kept:
            for x, sigma in self.kept["states"].values():
                for b in (x, sigma):
                    key = (tuple(b.shape), b.dtype, b.is_pinned())
                    self.pool[key] += [torch.empty_like(b, pin_memory=b.is_pinned())
                                       for _ in range(extra)]
        self.held, self.kept = [], None

    def _wrap(self, engine):
        enc, cond, smp, dfn, dec, dfs = (engine.encode_first_stage, engine.condition_pair,
                                         engine.sample, engine.denoise_fn, engine.decoder.forward,
                                         engine.decode_first_stage)
        span = self.spans.span

        def encode_first_stage(pixels, noise=None):
            with span("encode_first_stage"):
                z = enc(pixels, noise)
            if self.cur is not None:
                self.cur["latent"] = self.keep(z)
            return z

        def condition_pair(batch, force_uc_zero, skip_encode=False):
            with span("condition_pair"):
                c, uc = cond(batch, force_uc_zero, skip_encode)
            if self.cur is not None:
                self.cur["conds"].append(({k: self.keep(v) for k, v in batch.items()},
                                          frozenset(force_uc_zero), skip_encode,
                                          {k: self.keep(v) for k, v in c.items()},
                                          {k: self.keep(v) for k, v in uc.items()}))
            return c, uc

        def sample(*args, **kwargs):
            if self.cur is not None:
                self.cur["steps_done"] = 0
            with span("sample"):
                out = smp(*args, **kwargs)
            if self.cur is not None:
                self.cur["samples"].append(self.keep(out))
            return out

        def denoise_fn(*args):
            fn = dfn(*args)

            def step(x, sigma, c, mask):
                cur = self.cur
                if cur is not None:
                    i = cur["steps_done"]
                    if len(cur["samples"]) == self.round and i in self.states:
                        t = x.shape[0] // 2
                        cur["states"][i] = (self.keep(x[:t]), self.keep(sigma[:1]))
                    cur["steps_done"] = i + 1
                return fn(x, sigma, c, mask)

            return step

        def decoder_forward(z, n):
            out = dec(z, n)
            if self.cur is not None and len(self.cur["samples"]) == self.round + 1:
                # before the engine averages the seams in place
                self.cur["windows"].append((self.keep(z), self.keep(out)))
            return out

        def decode_first_stage(z):
            with span("decode_first_stage"):
                return dfs(z)

        engine.encode_first_stage, engine.condition_pair, engine.sample = (
            encode_first_stage, condition_pair, sample)
        engine.denoise_fn, engine.decoder.forward = denoise_fn, decoder_forward
        engine.decode_first_stage = decode_first_stage

    def start(self, index: int, seed: int):
        if self.armed and self.kept is None:
            self.cur = {"index": index, "seed": seed, "conds": [], "samples": [], "states": {},
                        "windows": [], "steps_done": 0, "round": self.round,
                        "steps": self.steps}

    def finish(self):
        if self.cur is not None:
            self.kept, self.cur = self.cur, None


def measure(cfg, traffic, seed, seconds, traced, device, readers):
    """Set up, warm up and run the window. Returns the window's numbers, the
    kept record and the system's parameter layout; the engine is freed."""
    from vista_tpu_torch.engine.engine import VistaEngine
    from vista_tpu_torch.engine.rollout import autoregressive_rollout
    from vista_tpu_torch.ops import _build

    t0 = time.perf_counter()
    engine = VistaEngine(harness.engine_config(cfg), device)
    layout = harness.engine_layout(engine)
    weights.fill_(harness.components(engine), harness.sub_seed(seed, 0))
    harness.log(f"engine built and filled in {time.perf_counter() - t0:.1f} s "
                f"(process {harness.process_age():.1f} s)")
    spans = trace.Spans()
    rec = Recorder(engine, cfg, traffic, harness.sub_seed(seed, 2), spans)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def request(i, steps=traffic["steps"]):
        req_seed = harness.sub_seed(seed, 1, i)
        images, batch, draws = inputs(engine.device, cfg, traffic, req_seed)
        sampler, rollout = configs(cfg, traffic, steps)
        rec.start(i, req_seed)
        with spans.span("request"):
            pixels, _ = autoregressive_rollout(engine, images, batch, sampler, rollout, draws)
        sync()
        rec.finish()
        return pixels.shape[0]

    t0 = time.perf_counter()
    rec.armed = True  # the warm-up's records take the host's pinned buffers the window's reuse
    request(0, steps=1)  # warm-up: every shape of a request, one denoiser step a round
    sync()
    rec.release()
    harness.log(f"warm-up request {time.perf_counter() - t0:.1f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _build.reset_counts()
    out = {"setup_s": harness.process_age()}
    if traced:
        record = {}
        units = traffic["trace_units"]
        with trace.profiled(spans, record):
            for i in range(units):
                request(i)
        record.update(units=units, denoiser_steps=units * traffic["rounds"] * traffic["steps"],
                      sites=dict(_build.SITES), model_flops=units * counts.request_flops(cfg, traffic),
                      launches=launch_bounds(cfg, traffic, units))
        out.update(per_layer=harness.per_layer(readers, record),
                   busy_s=trace.busy_s(record), window_s=trace.window_s(record),
                   breakdown=trace.breakdown(record), attempted=units)
    else:
        wall, n, frames = harness.window(seconds, request)
        out.update(wall=wall, attempted=n, frames=frames)
    sync()
    out["peak"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kept = rec.kept
    del engine, rec, spans, request
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, kept, layout


def launch_bounds(cfg, traffic, units):
    """The forward kernels' launches of ``units`` requests (from the shapes)."""
    e = cfg["engine"]
    f = counts.downsample(cfg)
    per = counts.unet_launches(e["unet"], 2, e["num_frames"], cfg["height"] // f, cfg["width"] // f)
    return [(l, units * traffic["rounds"] * traffic["steps"]) for l in per]


def readings(cfg, traffic, kept, ref, control=False) -> dict:
    """The numbers compared, each a worst relative L2 gap to the reference:
    the conditioning (``cond``), the encoder's latents (``latent``), the
    sigmas the denoiser got at the planned steps against the EDM schedule
    (``sigma``), the state entering the planned round (``init``: the
    round's noise scaled, the context frames pinned), the state after each
    planned step against the reference's Euler step from the system's state
    before it, as a share of that step (``step``: the guided denoiser, the
    guider's scales and the sampler's update), and the planned round's
    decoder windows together (``decode``). With ``control`` the reference
    one precision lower (fp8 products, a bf16 sampler state) stands in the
    system's place."""
    e = cfg["engine"]
    t, dev = e["num_frames"], ref.device
    scales = frame_scales(traffic["guider"], traffic["cfg_scale"], traffic["min_scale"], t)
    lower = (lambda: precision("fp8")) if control else contextlib.nullcontext
    here = lambda v: v.to(dev)
    sigmas = edm_sigmas(traffic["steps"], traffic["sigma_min"], traffic["sigma_max"], traffic["rho"])
    with lower():
        sigmas_got = edm_sigmas(traffic["steps"], traffic["sigma_min"], traffic["sigma_max"],
                                traffic["rho"])
    out = dict.fromkeys(CHECKS, 0.0)
    with torch.no_grad(), no_tf32():
        refs = []
        for batch, force, skip, c, uc in kept["conds"]:
            batch = {k: here(v) for k, v in batch.items()}
            r_c = ref.conditions(batch, frozenset(), skip)
            r_uc = ref.conditions(batch, force, skip)
            refs.append((r_c, r_uc))
            if control:
                with precision("fp8"):
                    c, uc = ref.conditions(batch, frozenset(), skip), ref.conditions(batch, force, skip)
            out["cond"] = max([out["cond"]] + [harness.rel(got[k], want[k]) for got, want in
                                               ((c, r_c), (uc, r_uc)) for k in want])
        images, _, draws = inputs(dev, cfg, traffic, kept["seed"])
        latent = ref.encode(images, draws.posterior)
        with lower():
            got = ref.encode(images, draws.posterior) if control else here(kept["latent"])
        out["latent"] = harness.rel(got, latent)

        r, nc = kept["round"], traffic["n_context"]
        if r == 0:
            mask = torch.zeros(t, device=dev)
            mask[:traffic["n_conds"]] = 1.0
            frames, frames_got = latent, got
        else:
            mask = (torch.arange(t, device=dev) < nc).float()
            frames = torch.zeros_like(latent)
            frames[:nc] = here(kept["samples"][r - 1])[-nc:]
            frames_got = frames
        states = {i: (here(x), float(s_)) for i, (x, s_) in kept["states"].items()}
        x0 = initial_state(draws.noise[r], float(sigmas[0]), frames, mask)
        with lower():
            x0_got = (initial_state(draws.noise[r], float(sigmas_got[0]), frames_got, mask)
                      if control else states[0][0])
        out["init"] = harness.rel(x0_got, x0)

        r_c, r_uc = refs[r]
        final = here(kept["samples"][r])
        for i in kept["steps"]:
            x, sigma_got = states[i]
            if control:
                sigma_got = float(sigmas_got[i])
            out["sigma"] = max(out["sigma"], abs(sigma_got - sigmas[i]) / sigmas[i])
            d = ref.guided_denoise(x, float(sigmas[i]), r_c, r_uc, mask, scales)
            want = euler(x, d, float(sigmas[i]), float(sigmas[i + 1]), mask)
            if control:
                with precision("fp8"):
                    d_got = ref.guided_denoise(x, float(sigmas_got[i]), r_c, r_uc, mask, scales)
                    nxt = euler(x, d_got, float(sigmas_got[i]), float(sigmas_got[i + 1]), mask)
            else:
                nxt = states[i + 1][0] if i + 1 in states else final
            gap = float(torch.linalg.vector_norm(nxt.double() - want))
            size = float(torch.linalg.vector_norm(want - x.double()))
            out["step"] = max(out["step"], gap / size)

        got, want = [], []
        for z, px in kept["windows"]:
            z = here(z).float()
            want.append(ref.decoder(z, z.shape[0]))
            if control:
                with precision("fp8"):
                    px = ref.decoder(z, z.shape[0])
            got.append(here(px))
        out["decode"] = harness.rel(torch.cat(got), torch.cat(want))
    return out


def run(cfg, traffic, limits, seed, seconds, traced, device, readers, control=False):
    """One run of a cell: ``(result, checks)``. With ``control`` the
    reference one precision lower is judged in the system's place."""
    out, kept, layout = measure(cfg, traffic, seed, seconds, traced, device, readers)
    rate = {} if traced else {"frames_per_s": {"value": out["frames"] / out["wall"],
                                               "unit": "frames/s"}}
    result = harness.result(out, device, rate)
    t0 = time.perf_counter()
    ref = Reference(cfg, device, harness.sub_seed(seed, 0), layout)
    got = readings(cfg, traffic, kept, ref, control)
    harness.log(f"check of request {kept['index']} against the reference: "
                f"{time.perf_counter() - t0:.1f} s")
    result["correct"], checks = harness.judge(got, limits)
    return result, checks


def survey(cfg, traffic, limits, seed, control, device) -> dict:
    """One seed's readings for :mod:`benchmark.control`: the system's (the
    first request of a window of one) and, with ``control``, the lower
    reference's in its place, each judged against ``limits``."""
    out, kept, layout = measure(cfg, traffic, seed, 0.0, False, device, {})
    ref = Reference(cfg, device, harness.sub_seed(seed, 0), layout)
    row = {"system": readings(cfg, traffic, kept, ref),
           "request_s": out["wall"], "peak_gib": out["peak"] / 2 ** 30}
    row["system_correct"] = harness.judge(row["system"], limits)[0]
    if control:
        row["control"] = readings(cfg, traffic, kept, ref, control=True)
        row["control_correct"] = harness.judge(row["control"], limits)[0]
    return row
