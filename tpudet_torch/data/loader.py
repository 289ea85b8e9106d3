"""Dataset protocol and the batching loader (``tpudet.data.loader``).

``Dataset``: ``len`` and ``get_example(i)`` returning ``{"image": uint8
[h, w, 3], "boxes": [n, 4], "classes": [n]}`` (and optionally
``difficult``, ``crowd``, ``area``, ``masks``, ``keypoints``,
``semantic``, ``id``).

``DataLoader`` shuffles per epoch, plans bucket-homogeneous batches, runs
``prepare_example`` on a thread pool (``prepare_example_jpeg`` where the
native front end decodes) and stacks fixed-shape uint8 batches;
its batch plans, shuffles and scale-jitter factors are the JAX loader's.
Under data parallelism ``batch_size`` is the global batch: every process
plans the same global batches (the bucket plan included) and loads its
rows of each (``process_rows``: ``process_index::process_count``, in an
order that keeps gradient accumulation's microbatches global), with their
``batch_valid`` rows, so the processes stay in step at every collective.
``device_stream(device)`` prefetches
them onto the card through a bounded queue: pinned host copies, copied with
``non_blocking=True`` on a stream of their own, so the copy overlaps the
step that runs meanwhile.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Protocol

import numpy as np
import torch

from tpudet_torch.config import Config
from tpudet_torch.data.native_decode import NativeDecodeError
from tpudet_torch.data.preprocess import (
    bucket_for_hw,
    prepare_example,
    prepare_example_jpeg,
)
from tpudet_torch.native import native_available


class Dataset(Protocol):
    def __len__(self) -> int: ...

    def get_example(self, index: int) -> Dict[str, np.ndarray]: ...


class _ProducerError:
    """Carries a producer thread's exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _resolve_decoder(cfg: Config, dataset) -> bool:
    """True -> the native C++ front end through ``dataset.get_raw``:
    ``data.decoder`` "native" (which raises where the dataset has no
    ``get_raw`` or the library does not build), or "auto" where both are
    there; "pil" and the rest of "auto" decode with ``get_example``."""
    mode = cfg.data.decoder
    if mode not in ("auto", "native", "pil"):
        raise ValueError(
            f"unknown data.decoder {mode!r} (use 'auto', 'native' or 'pil')")
    if mode == "pil":
        return False
    has_raw = hasattr(dataset, "get_raw")
    if mode == "native":
        if not has_raw:
            raise ValueError(f"decoder='native' but {type(dataset).__name__} "
                             "has no get_raw() (no JPEG source)")
        if not native_available():
            raise RuntimeError(
                "decoder='native' but the native decoder failed to build "
                "(g++ and libjpeg's headers are needed)")
        return True
    return has_raw and native_available()


def process_rows(batch_size: int, process_index: int, process_count: int,
                 accum_steps: int = 1) -> np.ndarray:
    """The rows of a global batch that process ``process_index`` of
    ``process_count`` holds, in its order. The train step splits a batch
    into ``accum_steps`` microbatches of strided rows (``a::accum_steps``);
    here each process's microbatch ``a`` is its share (``process_index::
    process_count``) of the global batch's microbatch ``a``. With one
    microbatch these are the rows ``process_index::process_count``."""
    return np.arange(batch_size).reshape(
        -1, process_count, accum_steps)[:, process_index].reshape(-1)


class DataLoader:
    def __init__(self, cfg: Config, dataset: Dataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True, prefetch: int = 2,
                 process_index: int | None = None,
                 process_count: int | None = None, augment: bool = False):
        self.cfg = cfg
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        # Host-side train augmentation (the train CLI's loader): the scale
        # jitter, deterministic per (seed, epoch, index).
        self.augment = augment
        jlo, jhi = cfg.data.scale_jitter
        if augment and (jlo, jhi) != (1.0, 1.0) and not 0.0 < jlo <= jhi:
            raise ValueError(
                f"data.scale_jitter {(jlo, jhi)} must satisfy 0 < lo <= hi")
        self.num_workers = num_workers
        self.drop_last = drop_last
        # A queue of maxsize 0 is unbounded: keep at least one batch.
        self.prefetch = max(1, prefetch)
        # One process unless the caller names its place in the group
        # (``parallel.DataParallel.rank`` and ``world_size``).
        self.process_index = process_index or 0
        self.process_count = process_count or 1
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process_index {process_index} outside "
                             f"process_count {process_count}")
        if batch_size % self.process_count:
            raise ValueError(
                f"global batch_size {batch_size} not divisible by "
                f"process_count {self.process_count}")
        self.accum_steps = max(1, cfg.train.accum_steps)
        if self.process_count > 1 and (batch_size // self.process_count
                                       ) % self.accum_steps:
            raise ValueError(
                f"per-process batch {batch_size // self.process_count} not "
                f"divisible by train.accum_steps {self.accum_steps}")
        self.global_batch_size = batch_size
        self.batch_size = batch_size // self.process_count
        self._epoch0_plan = None  # memo of _epoch_batch_indices(0)
        if drop_last and len(dataset) < batch_size:
            # Every epoch would plan no batch and the stream would spin.
            raise ValueError(
                f"dataset yields {len(dataset)} examples, fewer than the "
                f"global batch size {batch_size}; reduce batch_size or pass "
                "drop_last=False")
        if drop_last and self._bucketed and not self._epoch_batch_indices(0):
            raise ValueError(
                f"canvas bucketing with drop_last plans zero batches: no "
                f"bucket holds a full global batch of {batch_size}; reduce "
                "batch_size, pass drop_last=False, or coarsen the buckets")
        self.native_decode = _resolve_decoder(cfg, dataset)
        self._announced_fallback = False

    @property
    def _bucketed(self) -> bool:
        d = self.cfg.data
        return bool(d.aspect_buckets or d.orientation_buckets)

    def __len__(self) -> int:
        return len(self._epoch_batch_indices(0))

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def _epoch_batch_indices(self, epoch: int):
        """This process's ``(index_array [bs], valid_mask or None)`` batch
        plans of the epoch: the global plan, the same on every process, cut
        to this process's rows (``process_rows``). With bucketing every
        batch is bucket-homogeneous (one canvas per batch), and each
        bucket's tail pads by repeating its last example, masked by the
        valid mask when ``drop_last`` is off. The epoch-0 plan is
        memoized."""
        if epoch == 0 and self._epoch0_plan is not None:
            return self._epoch0_plan
        bs = self.global_batch_size
        order = self._epoch_order(epoch)
        if not self._bucketed:
            groups = [order]
        else:
            if not hasattr(self.dataset, "example_hw"):
                raise ValueError("canvas bucketing needs dataset.example_hw(i)")
            buckets = np.asarray([
                bucket_for_hw(self.cfg.data, *self.dataset.example_hw(int(i)))
                for i in order])
            groups = [order[buckets == b] for b in np.unique(buckets)]
        plans = []
        for g in groups:
            n_full = len(g) // bs
            for b in range(n_full):
                plans.append((g[b * bs:(b + 1) * bs], None))
            rem = len(g) - n_full * bs
            if rem and not self.drop_last:
                idx = np.concatenate([g[n_full * bs:], np.full(bs - rem, g[-1])])
                plans.append((idx, np.arange(bs) < rem))
        if self.shuffle and len(groups) > 1:
            np.random.default_rng((self.seed + epoch) ^ 0x5EED).shuffle(plans)
        if self.process_count > 1:
            rows = process_rows(bs, self.process_index, self.process_count,
                                self.accum_steps)
            plans = [(idx[rows], None if valid is None else valid[rows])
                     for idx, valid in plans]
        if epoch == 0:
            self._epoch0_plan = plans
        return plans

    def _jitter_factor(self, epoch: int, index: int) -> float:
        """The scale-jitter factor of one example, deterministic in (seed,
        epoch, index); 1.0 when augmentation or jitter is off."""
        lo, hi = self.cfg.data.scale_jitter
        if not self.augment or (lo, hi) == (1.0, 1.0):
            return 1.0
        rng = np.random.default_rng([self.seed, epoch, index])
        return float(rng.uniform(lo, hi))

    def _make_batch(self, pool, indices, epoch: int = 0
                    ) -> Dict[str, np.ndarray]:
        def one(i):
            factor = self._jitter_factor(epoch, int(i))
            if self.native_decode:
                ex = self.dataset.get_raw(int(i))
                try:
                    return prepare_example_jpeg(
                        self.cfg.data, ex["jpeg"], ex["boxes"], ex["classes"],
                        difficult=ex.get("difficult"), crowd=ex.get("crowd"),
                        area=ex.get("area"), masks=ex.get("masks"),
                        keypoints=ex.get("keypoints"),
                        semantic=ex.get("semantic"), scale_factor=factor)
                except NativeDecodeError:
                    # libjpeg does not take everything PIL does (CMYK/YCCK):
                    # this image goes through get_example. Other
                    # ValueErrors are bad arguments and propagate.
                    if not self._announced_fallback:
                        self._announced_fallback = True
                        print("loader: the native decoder rejected image "
                              f"{ex.get('id', i)!r}; such images decode "
                              "with PIL")
            ex = self.dataset.get_example(int(i))
            return prepare_example(
                self.cfg.data, ex["image"], ex["boxes"], ex["classes"],
                difficult=ex.get("difficult"), crowd=ex.get("crowd"),
                area=ex.get("area"), masks=ex.get("masks"),
                keypoints=ex.get("keypoints"), semantic=ex.get("semantic"),
                scale_factor=factor)

        examples = list(pool.map(one, indices))
        shapes = {tuple(ex["image"].shape) for ex in examples}
        if len(shapes) > 1:
            raise ValueError(
                "examples in one batch landed on different canvases "
                f"{sorted(shapes)} (dataset indices {list(indices)}): the "
                "annotations' height/width disagree with the image files")
        batch = {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}
        # Each row's dataset index (maps detections back to records).
        batch["example_index"] = np.asarray(indices, np.int32)
        return batch

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Host batches of one epoch; a padded tail carries
        ``batch_valid``."""
        pool = ThreadPoolExecutor(self.num_workers)
        try:
            for idx, valid in self._epoch_batch_indices(epoch):
                batch = self._make_batch(pool, idx, epoch)
                if valid is not None:
                    batch["batch_valid"] = valid
                yield batch
        finally:
            # An abandoned generator must not join the workers.
            pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Endless stream over epochs 0, 1, 2, ... on the card."""
        return self.device_stream()

    def device_stream(self, device="cuda", start_epoch: int = 0
                      ) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches of epochs ``start_epoch``, ``start_epoch + 1``, ... as
        tensors on ``device`` (CUDA unless the caller passes "cpu"), a
        producer thread ``prefetch`` batches ahead. On a CUDA device each
        batch is pinned and copied on a side stream; the consumer's stream
        waits on the copy before it sees the batch."""
        device = torch.device(device)
        cuda = device.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        copy_stream = torch.cuda.Stream(device) if cuda else None

        def to_device(batch):
            if not cuda:
                return {k: torch.from_numpy(v) for k, v in batch.items()}, None
            with torch.cuda.stream(copy_stream):
                dev = {k: torch.from_numpy(v).pin_memory().to(
                    device, non_blocking=True) for k, v in batch.items()}
                done = torch.cuda.Event()
                done.record(copy_stream)
            return dev, done

        def producer():
            epoch = start_epoch
            try:
                while not stop.is_set():
                    for batch in self.batches(epoch):
                        q.put(to_device(batch))
                        if stop.is_set():
                            return
                    epoch += 1
            except BaseException as e:  # noqa: BLE001
                # A dead producer would leave the consumer blocked forever.
                q.put(_ProducerError(e))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _ProducerError):
                    raise RuntimeError(
                        "DataLoader producer thread failed") from item.exc
                batch, done = item
                if done is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(done)
                    for t in batch.values():
                        t.record_stream(current)
                yield batch
        finally:
            stop.set()
            # Drain so that the producer sees the stop flag.
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
