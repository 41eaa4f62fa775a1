"""Multi-source sampling and a prefetching input pipeline on the host
(counterpart of ``vista_tpu/data/pipeline.py``).

A fixed virtual epoch, a weighted choice of source per sample, and a bounded
retry on bad samples (failures are counted and raised after the bound).
Worker threads decode batches into a bounded queue, so decoding overlaps the
card's work; a worker's error reaches the consumer.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    batch_size: int = 1
    prefetch: int = 2
    num_threads: int = 8
    max_retries: int = 100
    seed: int = 0


class MultiSourceSampler:
    """Weighted choice over datasets, retrying (bounded) on sample errors.

    Each worker thread draws from its own ``RandomState`` seeded from
    ``SeedSequence([seed, thread index])``: one shared stream mutated by
    several threads would give correlated or repeated draws.
    """

    def __init__(self, datasets: Sequence, probs: Optional[Sequence[float]] = None,
                 samples_per_epoch: int = 32000, max_retries: int = 100, seed: int = 0):
        assert datasets, "need at least one dataset"
        self.datasets = list(datasets)
        p = np.asarray(probs if probs is not None else [1.0] * len(datasets), np.float64)
        self.probs = p / p.sum()
        self.samples_per_epoch = samples_per_epoch
        self.max_retries = max_retries
        self.seed = seed
        self.error_count = 0  # monitoring only; benign under races
        self._tls = threading.local()
        self._thread_counter = itertools.count()

    def _rng(self) -> np.random.RandomState:
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            rng = np.random.RandomState(
                np.random.SeedSequence([self.seed, next(self._thread_counter)])
                .generate_state(1)[0])
            self._tls.rng = rng
        return rng

    def __len__(self):
        return self.samples_per_epoch

    def sample(self) -> Dict[str, np.ndarray]:
        rng = self._rng()
        for _ in range(self.max_retries):
            ds = self.datasets[rng.choice(len(self.datasets), p=self.probs)]
            idx = int(rng.randint(0, max(len(ds), 1)))
            try:
                return ds[idx]
            except Exception:
                self.error_count += 1
        raise RuntimeError(
            f"{self.max_retries} consecutive sample failures "
            f"({self.error_count} total): the data is likely corrupt or missing")


def _collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack each key that every sample has; a ragged optional key (an action
    modality that some samples lack) is dropped."""
    keys = set().union(*[s.keys() for s in samples])
    out = {}
    for k in keys:
        vals = [s[k] for s in samples if k in s]
        if len(vals) == len(samples):
            out[k] = np.stack(vals)
    return out


class DataPipeline:
    """Threaded decode and bounded prefetch; iterate for numpy batches."""

    def __init__(self, sampler: MultiSourceSampler, cfg: PipelineConfig):
        self.sampler = sampler
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = _collate([self.sampler.sample() for _ in range(self.cfg.batch_size)])
            except Exception as e:  # the consumer raises it
                self._put(e)
                return
            self._put(batch)

    def start(self, num_threads: Optional[int] = None):
        for _ in range(num_threads or self.cfg.num_threads):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 60.0) -> None:
        """Stop the workers and wait for each to finish its batch."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(deadline - time.monotonic(), 0.0))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self._threads:
            self.start()
        for _ in range(len(self.sampler) // self.cfg.batch_size):
            item = self._q.get()
            if isinstance(item, Exception):
                raise item
            yield item


# ---------------- typed data configuration and factory ----------------


@dataclasses.dataclass(frozen=True)
class SourceConfig:
    """One dataset source; ``kind``: synthetic | youtube | nuscenes."""

    kind: str = "synthetic"
    anno_file: str = ""
    data_root: str = ""
    prob: float = 1.0
    # youtube (OpenDV frame folders)
    pad_width: int = 9
    ext: str = ".jpg"
    # nuscenes oversampling
    balance_with_actions: bool = True
    oversample_complete: bool = True
    # synthetic
    length: int = 256
    with_actions: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    sources: Tuple[SourceConfig, ...] = ()
    # held-out sources for the runner's validation; empty: ``sources`` with
    # another sampling seed
    val_sources: Tuple[SourceConfig, ...] = ()
    batch_size: int = 1
    num_threads: int = 8
    prefetch: int = 2
    samples_per_epoch: int = 32000
    max_retries: int = 100
    seed: int = 0


def build_pipeline(cfg: DataConfig, height: int, width: int, num_frames: int,
                   synthetic: bool = False, process_index: int = 0) -> DataPipeline:
    """The datasets of the typed source configs in a prefetching pipeline.
    ``synthetic=True`` (or no sources) takes the synthetic dataset.
    ``process_index`` gives each data-parallel process its own sampling
    stream (one card: 0)."""
    from vista_tpu_torch.data.datasets import (DatasetConfig, NuScenesDataset,
                                               SyntheticVideoDataset, YouTubeFramesDataset)

    def ds_cfg(src: SourceConfig) -> DatasetConfig:
        return DatasetConfig(anno_file=src.anno_file, data_root=src.data_root,
                             height=height, width=width, num_frames=num_frames)

    datasets, probs = [], []
    if not synthetic:
        for src in cfg.sources:
            if src.kind == "synthetic":
                ds = SyntheticVideoDataset(ds_cfg(src), length=src.length,
                                           with_actions=src.with_actions)
            elif src.kind == "youtube":
                ds = YouTubeFramesDataset(ds_cfg(src), pad_width=src.pad_width, ext=src.ext)
            elif src.kind == "nuscenes":
                ds = NuScenesDataset(ds_cfg(src), balance=src.balance_with_actions,
                                     oversample_complete=src.oversample_complete)
            else:
                raise ValueError(f"unknown data source kind {src.kind!r}")
            if len(ds) == 0:
                raise FileNotFoundError(
                    f"source {src.kind!r}: no samples (anno_file={src.anno_file!r})")
            datasets.append(ds)
            probs.append(src.prob)
    if not datasets:
        datasets = [SyntheticVideoDataset(
            DatasetConfig(height=height, width=width, num_frames=num_frames), length=256)]
        probs = [1.0]
    seed = int(np.random.SeedSequence([cfg.seed, process_index]).generate_state(1)[0])
    sampler = MultiSourceSampler(datasets, probs=probs, samples_per_epoch=cfg.samples_per_epoch,
                                 max_retries=cfg.max_retries, seed=seed)
    return DataPipeline(sampler, PipelineConfig(
        batch_size=cfg.batch_size, prefetch=cfg.prefetch, num_threads=cfg.num_threads,
        max_retries=cfg.max_retries, seed=seed))
