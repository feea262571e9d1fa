"""Batch pipeline: host decode/augment pool -> padded host batches.

Port of ``rpo_tpu/data/loader.py``: a thread pool decodes and resizes
(numpy releases the interpreter lock in its array loops) and a bounded
prefetch queue lets the host prepare the next batches while the device
computes.

Batches are dicts {"img": (B, H, W, 3) uint8, "label": (B,) int32,
"mask": (B,) float32, "n": int} where B is always ``pad_to`` (the batch
size, or the next multiple of the data ranks: ``dp.pad_multiple``): the
final partial batch and the rows past the batch size are zero-padded and
flagged by ``mask``, so every step sees one shape.  ``n`` counts the real
rows of the whole batch.

Under a data mesh each rank's loader is given its ``rows`` [a, b) of the
padded batch: it draws every row's augmentation plan, as every rank does,
and decodes only its own rows, so the ranks' batches concatenate to the
JAX package's padded global batch and no rank decodes another's images.

Seeded determinism, as in the JAX package: an epoch draws from Python's
global ``random`` on the consumer thread only, the shuffle and then one
seed for a private ``random.Random`` from which the producer draws every
per-image augmentation plan in item order.  The global stream therefore
advances by the same draws as the JAX loader's, and the two give equal
batches.  With INPUT.DEVICE_RESIZE a train batch carries the raw sources
and the drawn crop boxes and flips instead (``_make_device_augment_batch``),
which the train step applies on the device.

An all-JPEG batch goes to the native pipeline (``rpo_tpu_torch/_native``)
whole: its C++ thread pool of ``num_workers`` threads decodes, resizes,
crops and flips every image by the plans drawn here, and an image it
refuses falls back to the Python path alone.  Without the library
(``RPO_TPU_NO_NATIVE=1``, or no compiler or libjpeg) the Python thread
pool does the batch.
"""
from __future__ import annotations

import ctypes
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .._native import get_lib
from .datum import Datum
from .transforms import is_jpeg

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
        pad_to: Optional[int] = None,
        rows: Optional[Tuple[int, int]] = None,
    ):
        self.items = list(items)
        self.transform = transform
        self.batch_size = int(batch_size)
        self.pad_to = int(pad_to) if pad_to else self.batch_size
        if self.pad_to < self.batch_size:
            raise ValueError(f"pad_to {self.pad_to} is below the batch size {self.batch_size}")
        # this rank's rows of the padded batch (all of them on one process)
        self.rows = tuple(rows) if rows is not None else (0, self.pad_to)
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

    def _mine(self, batch_items: List[Datum], plans=None):
        """This rank's items of the batch (and their plans): those of its
        rows that are not padding."""
        a, b = self.rows
        items = batch_items[a:b]
        return items, (plans[a:b] if plans is not None else None)

    def _make_batch(self, batch_items: List[Datum], rng=None) -> Dict[str, np.ndarray]:
        if self.train and getattr(self.transform, "device_resize", 0):
            return self._make_device_augment_batch(batch_items, rng=rng)
        # the plans are drawn here, for every row of the batch in item
        # order, from the private per-epoch rng, whichever rows this rank
        # decodes; the native pool or the thread pool only decodes and
        # resizes.  Eval batches draw none (make_plan(train=False) is None)
        # and never reach the native train entry point
        has_plan = self.train and hasattr(self.transform, "make_plan")
        plans = [self.transform.make_plan(it.impath, True, rng=rng) if has_plan else None
                 for it in batch_items]
        items, plans = self._mine(batch_items, plans)
        imgs = self._native_eval_batch(items) if items else []
        if imgs is None:
            imgs = self._native_train_batch(items, plans) if has_plan else None
        if imgs is None:

            def apply(item_plan):
                item, plan = item_plan
                if has_plan:
                    return self.transform(item.impath, self.train, plan=plan)
                return self.transform(item.impath, self.train)

            imgs = list(self.pool.map(apply, zip(items, plans)))
        a, b = self.rows
        shape = imgs[0].shape if imgs else self._image_shape()
        out_img = np.zeros((b - a,) + tuple(shape), dtype=np.uint8)
        out_lab = np.zeros((b - a,), dtype=np.int32)
        out_mask = np.zeros((b - a,), dtype=np.float32)
        for i, (im, it) in enumerate(zip(imgs, items)):
            out_img[i] = im
            out_lab[i] = it.label
            out_mask[i] = 1.0
        return self._with_all_labels(
            {"img": out_img, "label": out_lab, "mask": out_mask, "n": len(batch_items)},
            batch_items)

    def _with_all_labels(self, batch: dict, batch_items: List[Datum]) -> dict:
        """A rank's batch with ``all_label``, the labels of the whole padded
        batch (no decode needed), which the evaluator reads beside the
        gathered logits; a whole batch has them in ``label``."""
        if self.rows != (0, self.pad_to):
            labels = np.zeros((self.pad_to,), np.int32)
            labels[:len(batch_items)] = [it.label for it in batch_items]
            batch["all_label"] = labels
        return batch

    def _image_shape(self) -> Tuple[int, int, int]:
        """The shape of a decoded image, for a rank whose rows are all
        padding: the model's size, or the device-resize sources'."""
        side = getattr(self.transform, "device_resize", 0) or self.transform.size
        return (side, side, 3)

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
        # one header read an image of the batch: the size feeds the plan
        # (every row's, in item order) and the check
        sizes = [tp.image_size(it.impath) for it in batch_items]
        plans = [tp.make_plan(it.impath, True, size=sz, rng=rng)
                 for it, sz in zip(batch_items, sizes)]
        n, (a, b) = len(batch_items), self.rows
        all_items = batch_items
        batch_items, plans, sizes = batch_items[a:b], plans[a:b], sizes[a:b]
        exact = [sz == (S, S) for sz in sizes]
        # all sources exact: the native batch decode (at size S its eval
        # entry point is raw_source), else the thread pool
        imgs = self._native_fixed_batch(batch_items, S) if batch_items and all(exact) else None
        if imgs is None:
            host_boxes = [None if (ex or plan is None) else plan[0]
                          for ex, plan in zip(exact, plans)]
            imgs = list(self.pool.map(lambda ib: tp.raw_source(ib[0].impath, box=ib[1]),
                                      zip(batch_items, host_boxes)))
        B = b - a
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
        return self._with_all_labels({"img": out_img, "label": out_lab, "mask": out_mask,
                                      "n": n, "box": out_box, "flip": out_flip}, all_items)

    def _native_train_batch(self, batch_items: List[Datum], plans):
        """A train batch of JPEGs decoded, cropped, resized and flipped by
        ``plans`` in the C++ thread pool (None where the native path does
        not apply); an image it refuses goes through the Python path."""
        tp = self.transform
        if not self.train or not hasattr(tp, "size") or \
                getattr(tp, "interpolation", "") != "bicubic" or \
                not all(is_jpeg(it.impath) for it in batch_items):
            return None
        lib = get_lib()
        if lib is None:
            return None
        n, size = len(batch_items), tp.size
        boxes = np.full((n, 4), -1, np.int32)  # no box: resize-shorter and centre crop
        flips = np.zeros((n,), np.uint8)
        for i, plan in enumerate(plans):
            if plan is None:
                continue
            box, flip = plan
            flips[i] = 1 if flip else 0
            if box is not None:
                boxes[i] = box
        out = np.empty((n, size, size, 3), np.uint8)
        ok = np.zeros((n,), np.uint8)
        paths = (ctypes.c_char_p * n)(*[it.impath.encode() for it in batch_items])
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rpo_train_preprocess_batch(
            paths, boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            flips.ctypes.data_as(u8p), n, size, out.ctypes.data_as(u8p),
            ok.ctypes.data_as(u8p), self.num_workers)
        return [out[i] if ok[i] else tp(it.impath, True, plan=plans[i])
                for i, it in enumerate(batch_items)]

    def _native_eval_batch(self, batch_items: List[Datum]):
        if self.train:
            return None
        tp = self.transform
        # with DEVICE_RESIZE = S an eval batch ships the (S, S) sources:
        # resize-shorter to S and a centre crop of S is raw_source's
        size = getattr(tp, "device_resize", 0) or getattr(tp, "size", 0)
        return self._native_fixed_batch(batch_items, size)

    def _native_fixed_batch(self, batch_items: List[Datum], size: int):
        """A batch of JPEGs decoded, resized shorter side first and
        centre-cropped to ``size`` in the C++ thread pool (None where the
        native path does not apply); an image it refuses goes through the
        Python path at the same size."""
        tp = self.transform
        if not size or getattr(tp, "interpolation", "") != "bicubic" or \
                not all(is_jpeg(it.impath) for it in batch_items):
            return None
        lib = get_lib()
        if lib is None:
            return None
        n = len(batch_items)
        out = np.empty((n, size, size, 3), np.uint8)
        ok = np.zeros((n,), np.uint8)
        paths = (ctypes.c_char_p * n)(*[it.impath.encode() for it in batch_items])
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rpo_eval_preprocess_batch(paths, n, size, out.ctypes.data_as(u8p),
                                      ok.ctypes.data_as(u8p), self.num_workers)
        # a refused image: raw_source at S for DEVICE_RESIZE, never the
        # full-size transform
        resized = getattr(tp, "device_resize", 0) == size
        return [out[i] if ok[i] else
                (tp.raw_source(it.impath) if resized else tp(it.impath, False))
                for i, it in enumerate(batch_items)]

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
