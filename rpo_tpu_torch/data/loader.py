"""Batch pipeline: host decode/augment pool -> padded host batches.

Port of ``rpo_tpu/data/loader.py``: a thread pool decodes and resizes
(numpy releases the interpreter lock in its array loops) and a bounded
prefetch queue lets the host prepare the next batches while the device
computes.

Batches are dicts {"img": (B, H, W, 3) uint8, "label": (B,) int32,
"mask": (B,) float32, "n": int} where B is always the batch size: the
final partial batch is zero-padded and flagged by ``mask``, so every step
sees one shape.  (Padding to a multiple of several cards waits for the
multi-GPU port.)

Seeded determinism, as in the JAX package: an epoch draws from Python's
global ``random`` on the consumer thread only, the shuffle and then one
seed for a private ``random.Random`` from which the producer draws every
per-image augmentation plan in item order.  The global stream therefore
advances by the same draws as the JAX loader's, and the two give equal
batches.  With INPUT.DEVICE_RESIZE a train batch carries the raw sources
and the drawn crop boxes and flips instead (``_make_device_augment_batch``),
which the train step applies on the device.  Left for later: the native
JPEG paths, which a synthetic source never reaches (Pillow and the numpy
resample decode and resize a file meanwhile).
"""
from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np

from .datum import Datum

PREFETCH = 2  # batches the producer may have ready ahead of the consumer


class BatchLoader:
    def __init__(
        self,
        items: Sequence[Datum],
        transform: Callable[..., np.ndarray],
        batch_size: int,
        train: bool,
        shuffle: bool,
        num_workers: int = 8,
        drop_last: bool = False,
    ):
        self.items = list(items)
        self.transform = transform
        self.batch_size = int(batch_size)
        # Dassl drops the final partial TRAIN batch (when the dataset has
        # at least one full batch): the reference's step count
        self.drop_last = bool(drop_last) and len(self.items) >= self.batch_size
        self.train = train
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.pool = ThreadPoolExecutor(max_workers=self.num_workers)

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.items) // self.batch_size
        return (len(self.items) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, batch_items: List[Datum], rng=None) -> Dict[str, np.ndarray]:
        if self.train and getattr(self.transform, "device_resize", 0):
            return self._make_device_augment_batch(batch_items, rng=rng)
        # the plans are drawn here, in item order, from the private
        # per-epoch rng; the pool only decodes and resizes.  Eval batches
        # draw none (make_plan(train=False) is None)
        has_plan = self.train and hasattr(self.transform, "make_plan")
        plans = [self.transform.make_plan(it.impath, True, rng=rng) if has_plan else None
                 for it in batch_items]

        def apply(item_plan):
            item, plan = item_plan
            if has_plan:
                return self.transform(item.impath, self.train, plan=plan)
            return self.transform(item.impath, self.train)

        imgs = list(self.pool.map(apply, zip(batch_items, plans)))
        B = self.batch_size
        out_img = np.zeros((B,) + imgs[0].shape, dtype=imgs[0].dtype)
        out_lab = np.zeros((B,), dtype=np.int32)
        out_mask = np.zeros((B,), dtype=np.float32)
        for i, (im, it) in enumerate(zip(imgs, batch_items)):
            out_img[i] = im
            out_lab[i] = it.label
            out_mask[i] = 1.0
        return {"img": out_img, "label": out_lab, "mask": out_mask, "n": len(batch_items)}

    def _make_device_augment_batch(self, batch_items: List[Datum],
                                   rng=None) -> Dict[str, np.ndarray]:
        """A train batch of INPUT.DEVICE_RESIZE = S: the (S, S, 3) uint8
        sources, 'box' (B, 4) int32 [left, top, crop_w, crop_h] and 'flip'
        (B,) int32, which the train step applies on the device
        (``ops.preprocess.device_train_preprocess``).  The plans are drawn
        in item order from the private per-epoch ``rng``, as on the host
        path; a source of another size than (S, S) has its crop applied
        here (``raw_source``) and a full-frame box, as do rows without a
        crop plan and padding rows."""
        tp = self.transform
        S = tp.device_resize
        # one header read an image: the size feeds the plan and the check
        sizes = [tp.image_size(it.impath) for it in batch_items]
        plans = [tp.make_plan(it.impath, True, size=sz, rng=rng)
                 for it, sz in zip(batch_items, sizes)]
        exact = [sz == (S, S) for sz in sizes]
        host_boxes = [None if (ex or plan is None) else plan[0]
                      for ex, plan in zip(exact, plans)]
        imgs = list(self.pool.map(lambda ib: tp.raw_source(ib[0].impath, box=ib[1]),
                                  zip(batch_items, host_boxes)))
        B = self.batch_size
        out_img = np.zeros((B, S, S, 3), np.uint8)
        out_lab = np.zeros((B,), np.int32)
        out_mask = np.zeros((B,), np.float32)
        out_box = np.tile(np.asarray([0, 0, S, S], np.int32), (B, 1))
        out_flip = np.zeros((B,), np.int32)
        for i, (im, it, plan) in enumerate(zip(imgs, batch_items, plans)):
            out_img[i] = im
            out_lab[i] = it.label
            out_mask[i] = 1.0
            if plan is not None:
                box, flip = plan
                if box is not None and exact[i]:
                    out_box[i] = box
                out_flip[i] = 1 if flip else 0
        return {"img": out_img, "label": out_lab, "mask": out_mask, "n": len(batch_items),
                "box": out_box, "flip": out_flip}

    def _order(self) -> List[int]:
        order = list(range(len(self.items)))
        if self.shuffle:
            random.shuffle(order)
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # One live producer per loader: an abandoned epoch's producer may
        # still be inside a batch; mark it abandoned and join it, and hand
        # a still-active old consumer an error instead of a deadlock.  The
        # determinism does not depend on this join (see the module
        # docstring).
        prev = getattr(self, "_producer", None)
        if prev is not None and prev.is_alive():
            self._producer_abandoned.set()
            prev.join()
            prev_q = self._q
            try:
                while True:
                    prev_q.get_nowait()
            except queue.Empty:
                pass
            prev_q.put_nowait(RuntimeError(
                "a new iteration of this BatchLoader started while a previous iterator was "
                "still active; concurrent iterators over one loader are unsupported (the "
                "seeded augmentation randomness is drawn sequentially)"))
        # all of this epoch's global-stream draws, on this thread: the
        # shuffle and one seed
        order = self._order()
        epoch_rng = random.Random(random.getrandbits(64))
        chunks = [
            [self.items[j] for j in order[i:i + self.batch_size]]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and chunks and len(chunks[-1]) < self.batch_size:
            chunks.pop()
        if not chunks:
            return
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            """A bounded put that notices an abandoned consumer, so a
            caller that drops the iterator mid-epoch does not park this
            thread on a full queue forever."""
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for chunk in chunks:
                    if not put(self._make_batch(chunk, rng=epoch_rng)):
                        return
                put(stop)
            except Exception as exc:  # handed to the consumer, which raises it
                put(exc)

        t = threading.Thread(target=producer, daemon=True, name="batch-producer")
        self._producer = t
        self._producer_abandoned = abandoned
        self._q = q
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is stop:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            abandoned.set()  # the generator closed, normally or not
