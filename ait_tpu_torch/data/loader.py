"""Host-side batch pipeline producing fixed-shape batches (counterpart of
ait_tpu/data/loader.py, its numpy path).

Re-design of the reference's torch DataLoader stack (roibatchLoader.py +
minibatch.py + the custom whole-batch-permutation sampler,
trainval_net_voc.py:153-176):

  * the per-batch dynamic aspect-ratio canvas (roibatchLoader.py:51-69,
    139-253: crop/pad every batch to its own target ratio) becomes a SMALL
    FIXED SET of static canvases: the base cfg.tpu.image_size, wider
    buckets (cfg.tpu.wide_buckets) for high-aspect images, and transposes
    for portrait ones (_canvas_for).  Shortest side scales to
    TRAIN.SCALES[0] exactly (matching the reference's unclamped resize,
    blob.py:56-58) for every aspect ratio the widest bucket covers; beyond
    it the scale is capped to fit.  Each canvas = one compiled program;
    batches are canvas-homogeneous; `im_info` carries the true extent so
    anchors/clipping see the real image, not the padding;
  * query-class choice ~ inverse class frequency (roibatchLoader.py:111-123),
    gt relabeled to binary same-class=1/else 0 (`:126`), gt rows shuffled and
    zero-padded to MAX_NUM_GT_BOXES (`:140,264-270`);
  * eval iterates (image x present-class) pairs (test_rank_roidb_ratio,
    roidb.py:91-128) with the reference's EXACT deterministic query-shot
    selection: `random.seed(img_id)`, shuffle, pick `query_position`-th
    (roibatchLoader.py:299-307) — needed for shot-averaged AP parity;
  * a background thread replaces the 8 DataLoader worker processes: with
    uint8 inputs (`tpu.input_uint8`, the default) it hands each batch's
    pixel work to the C++ threads of ait_tpu_torch/native.py (the native
    route: flip, scale, canvas, space-to-depth and the query crops, no
    interpreter lock held), otherwise to a Python worker pool running the
    numpy transforms; both routes give the same bytes, and batches land as
    ready numpy arrays (data/prefetch.py copies them to the device);
  * the rng-bearing sampling draws from the same generators in the same
    order as the JAX package's loader, so the metadata is bit-identical to
    it and the pixels are those of cv2's resize (transforms.resize_linear);
  * images are read by `imread(path)`: by default imageio, imported when
    the first image is read; a caller without imageio passes its own.
"""

from __future__ import annotations

import random as pyrandom
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ait_tpu_torch import native
from ait_tpu_torch.config import Config
from ait_tpu_torch.data.records import DatasetView
from ait_tpu_torch.data.transforms import (CANVAS_FILL, crop_query, normalize,
                                           place_on_canvas, prep_image,
                                           space_to_depth, to_rgb3)


def imageio_read(path: str) -> np.ndarray:
    """The default image reader: imageio, imported at the first read."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(
            "OneShotLoader reads images with imageio, which is not "
            "installed: pass imread=<a function path -> HxWx3 uint8 array>"
        ) from e
    return np.asarray(imageio.imread(path))


def _shot_order(img_id: int, n: int) -> list:
    """The reference's seed-by-img-id deterministic shot shuffle
    (roibatchLoader.py:299-307).  A LOCAL Random(img_id) produces the
    identical Mersenne sequence as `random.seed(img_id); random.shuffle`
    while staying thread-safe under the ThreadPoolExecutor pipeline
    (seeding the global module from concurrent workers would make shot
    selection timing-dependent)."""
    order = list(range(n))
    pyrandom.Random(img_id).shuffle(order)
    return order


class OneShotLoader:
    """Train/eval batch producer for one dataset view."""

    def __init__(self, view: DatasetView, cfg: Config, *, training: bool,
                 seed: Optional[int] = None, process_index: int = 0,
                 process_count: int = 1,
                 imread: Optional[Callable[[str], np.ndarray]] = None):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range "
                             f"for process_count {process_count}")
        self.view = view
        self.cfg = cfg
        self.imread = imread or imageio_read
        self.training = training
        self.canvas = cfg.tpu.image_size
        self.query_size = cfg.TRAIN.query_size
        self.max_gt = cfg.MAX_NUM_GT_BOXES
        # multi-host (pod) input sharding, SURVEY §2.10: every host sees the
        # SAME epoch order / batch membership (order_rng is host-invariant
        # and advances once per epoch on all hosts), but prepares only its
        # 1/process_count slice of each global batch.  Item-level sampling
        # (query class/shot, flips, gt shuffle) is host-local, so its rng is
        # decorrelated by process_index; at process_count == 1 both seeds
        # reduce to the single-host values.  Nothing in the port sets
        # process_count > 1 yet: the multi-host trainer (ROADMAP A15) will.
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        base_seed = cfg.RNG_SEED if seed is None else seed
        self.rng = np.random.RandomState(
            base_seed + self.process_index * 1000003)
        self.order_rng = np.random.RandomState(base_seed)
        self.query_position = 0
        self.uint8 = bool(cfg.tpu.input_uint8)
        self.portrait_bucket = bool(cfg.tpu.portrait_bucket)
        self.wide_buckets = tuple(cfg.tpu.wide_buckets or ())
        # ship target images space-to-depth'd ([H/2, W/2, 12] u8), the
        # input of the resnet stem's 12-plane convolution
        self.host_s2d = (bool(cfg.tpu.host_s2d)
                         and self.uint8
                         and cfg.model.backbone.startswith("resnet")
                         and self.canvas[0] % 2 == 0
                         and self.canvas[1] % 2 == 0)
        # TRAIN.USE_ALL_GT=False (config.py:160-161, minibatch.py:38-44):
        # exclude iscrowd gt from COCO training batches.  iscrowd rides the
        # records' `difficult` field for coco views only — VOC's difficult
        # flag is NOT excluded under this knob (the reference keys on the
        # crowd overlaps=-1 convention, which VOC never sets).
        self.drop_crowd_gt = (training
                              and not bool(cfg.TRAIN.USE_ALL_GT)
                              and view.name.startswith("coco"))

        if training:
            if cfg.TRAIN.USE_FLIPPED:
                view.append_flipped()
            view.filter_boxless()
            self.freq = view.class_frequencies()
            self.pairs: List[Tuple[int, int]] = []
        else:
            aset = set(view.allowed_classes)
            # eval pairs come from the reference's np.unique(max_classes)
            # (test_rank_roidb_ratio, roidb.py:116-120); COCO crowd rows
            # carry overlaps=-1 whose argmax is class 0, so a class present
            # ONLY as crowd creates no pair (iscrowd rides `difficult` for
            # coco views; VOC's difficult boxes keep normal overlaps and DO
            # pair — pascal_voc.py:241 comments out its use_diff filter)
            is_coco = view.name.startswith("coco")
            self.pairs = []
            for i, r in enumerate(view.records):
                cls = (r.gt_classes[r.difficult == 0] if is_coco
                       else r.gt_classes)
                self.pairs.extend((i, int(c)) for c in np.unique(cls)
                                  if int(c) in aset)
            self.freq = {}

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.view.records) if self.training else len(self.pairs)

    def _canvas_for(self, rec) -> tuple:
        """Static canvas bucket for one record.

        The TPU analog of the reference's aspect-ratio batch grouping
        (roibatchLoader.py:51-69): a small set of static canvases — the
        configured one, optional wider buckets (cfg.tpu.wide_buckets) for
        high-aspect images that a fixed canvas would otherwise downscale
        below the reference's unclamped shortest-side-600 (blob.py:56-58),
        and the transpose of the chosen canvas for portrait images.  Batches
        are kept canvas-homogeneous so each shape compiles once."""
        portrait = self.portrait_bucket and rec.height > rec.width
        base = self.canvas
        # record dims in landscape orientation (portrait uses the transpose)
        h, w = ((rec.width, rec.height) if portrait
                else (rec.height, rec.width))
        chosen = base
        wide = sorted(tuple(b) for b in (self.wide_buckets or ())
                      if b[0] == base[0] and b[1] > base[1])
        if wide and h > 0 and w > 0:
            target = (self.cfg.TRAIN.SCALES if self.training
                      else self.cfg.TEST.SCALES)[0]
            s = float(target) / min(h, w)
            for cand in [base] + wide:
                if round(h * s) <= cand[0] and round(w * s) <= cand[1]:
                    chosen = cand
                    break
            else:
                chosen = wide[-1]  # widest bucket; scale capped there
        return (chosen[1], chosen[0]) if portrait else chosen

    def _read(self, path: str) -> np.ndarray:
        return to_rgb3(np.asarray(self.imread(path)))

    def _prep_image(self, rec):
        im = self._read(rec.image_path)
        if rec.flipped:
            im = im[:, ::-1, :]
        scales = (self.cfg.TRAIN.SCALES if self.training
                  else self.cfg.TEST.SCALES)
        canvas = self._canvas_for(rec)
        im, scale = prep_image(im, scales[0], max_hw=canvas,
                               keep_uint8=self.uint8)
        h, w = im.shape[:2]
        out = place_on_canvas(im, canvas)
        if self.host_s2d:
            out = space_to_depth(out)
        return out, h, w, scale

    def _prep_query(self, exemplar, flip: bool) -> np.ndarray:
        im = self._read(exemplar.image_path)
        # the reference resizes the uint8 crop BEFORE normalizing
        # (roibatchLoader.py:318-329), so uint8 mode is exactly faithful here
        q = crop_query(im, exemplar.box, self.query_size)
        if flip:
            q = q[:, ::-1, :]
        return np.ascontiguousarray(q) if self.uint8 else normalize(q)

    # ------------------------------------------------------------------
    def _scale_for(self, rec) -> float:
        """The scale `_prep_image` gives an image of the record's size."""
        target = (self.cfg.TRAIN.SCALES if self.training
                  else self.cfg.TEST.SCALES)[0]
        canvas = self._canvas_for(rec)
        return min(float(target) / min(rec.height, rec.width),
                   canvas[0] / rec.height, canvas[1] / rec.width)

    def _train_draws(self, index: int):
        """The sampling of one train item, drawn from self.rng in the JAX
        loader's order (query class, exemplar, query flip, gt order) and
        before any pixel work, so that a batch's draws do not depend on
        which worker thread runs first."""
        rec = self.view.records[index]
        aset = set(self.view.allowed_classes)
        keep = np.array([int(c) in aset for c in rec.gt_classes], bool)
        if self.drop_crowd_gt:
            keep &= rec.difficult == 0
        boxes = rec.boxes[keep].astype(np.float32)
        classes = rec.gt_classes[keep]

        cand = np.unique(classes)
        if len(cand) == 1:
            choice = int(cand[0])
        else:
            p = np.array([self.freq[int(c)] for c in cand])
            choice = int(self.rng.choice(cand, 1, p=p / p.sum())[0])

        labels = (classes == choice).astype(np.float32)
        exemplar = self.view.cat_data[choice][
            self.rng.randint(len(self.view.cat_data[choice]))]
        flip = bool(self.rng.rand() > 0.5)
        # drop degenerate boxes (roibatchLoader.py:257-262), then shuffle;
        # the record's size stands for the image's, as in the JAX loader's
        # native path
        scaled = boxes * self._scale_for(rec)
        ok = (scaled[:, 0] != scaled[:, 2]) & (scaled[:, 1] != scaled[:, 3])
        order = np.arange(int(ok.sum()))
        self.rng.shuffle(order)
        return rec, exemplar, flip, boxes[ok][order], labels[ok][order]

    def _gt_rows(self, boxes, labels, scale: float):
        """(gt [max_gt, 5] float32 zero-padded, count) of a train item's
        drawn boxes at the image's scale."""
        gt = np.concatenate([boxes * scale, labels[:, None]], axis=1)
        n = min(len(gt), self.max_gt)
        gt_pad = np.zeros((self.max_gt, 5), np.float32)
        gt_pad[:n] = gt[:n]
        return gt_pad, n

    def _train_prepared(self, draws) -> Dict[str, np.ndarray]:
        rec, exemplar, flip, boxes, labels = draws
        query = self._prep_query(exemplar, flip=flip)
        image, h, w, scale = self._prep_image(rec)
        gt_pad, n = self._gt_rows(boxes, labels, scale)
        return {
            "image": image,
            "query": query,
            "im_info": np.array([h, w, scale], np.float32),
            "gt_boxes": gt_pad,
            "num_boxes": np.int32(n),
        }

    def train_item(self, index: int) -> Dict[str, np.ndarray]:
        return self._train_prepared(self._train_draws(index))

    def _test_exemplar(self, pair_index: int):
        """(record, exemplar) of an eval pair: the query shot at
        query_position of the pair's seed-by-img-id order."""
        rec_idx, cls = self.pairs[pair_index]
        rec = self.view.records[rec_idx]
        pool = self.view.cat_data[cls]
        order = _shot_order(rec.img_id, len(pool))
        return rec, pool[order[self.query_position % len(order)]]

    def test_item(self, pair_index: int) -> Dict[str, np.ndarray]:
        rec_idx, cls = self.pairs[pair_index]
        rec, exemplar = self._test_exemplar(pair_index)
        query = self._prep_query(exemplar, flip=False)

        image, h, w, scale = self._prep_image(rec)
        return {
            "image": image,
            "query": query,
            "im_info": np.array([h, w, scale], np.float32),
            "gt_boxes": np.zeros((self.max_gt, 5), np.float32),
            "num_boxes": np.int32(0),
            "pair_index": np.int32(pair_index),
            "record_index": np.int32(rec_idx),
            "category": np.int32(cls),
        }

    def fused_item(self, pair_index: int, shots: int):
        """One pair with ALL `shots` query positions stacked ([A, q, q, 3])
        and the target image ONCE — the input unit of the shot-fused eval
        step (train.make_fused_eval_step).  Shot selection is identical to
        test_item at each query_position: one seed-by-img-id shuffle, then
        positions 0..A-1 of the same order (test_net_voc.py:320-322 runs
        the same selector A times)."""
        rec_idx, cls = self.pairs[pair_index]
        rec = self.view.records[rec_idx]
        pool = self.view.cat_data[cls]
        order = _shot_order(rec.img_id, len(pool))
        queries = np.stack([
            self._prep_query(pool[order[a % len(order)]], flip=False)
            for a in range(shots)])

        image, h, w, scale = self._prep_image(rec)
        return {
            "image": image,
            "query": queries,
            "im_info": np.array([h, w, scale], np.float32),
            "gt_boxes": np.zeros((self.max_gt, 5), np.float32),
            "num_boxes": np.int32(0),
            "pair_index": np.int32(pair_index),
            "record_index": np.int32(rec_idx),
            "category": np.int32(cls),
        }

    def test_epoch_fused(self, unique_batch: int, shots: int, *,
                         num_workers: int = 8, prefetch: int = 4
                         ) -> Iterator[Dict[str, np.ndarray]]:
        """Shot-fused epoch: batches of `unique_batch` pairs, each carrying
        its `shots` queries (pair batch = unique_batch * shots).  Same pair
        order / orientation grouping / tail padding as test_epoch."""
        order = list(range(len(self.pairs)))
        batches = []
        for group in self._orientation_groups(
                order,
                lambda i: self._canvas_for(
                    self.view.records[self.pairs[i][0]])):
            pad = (-len(group)) % unique_batch
            group = group + [group[-1]] * pad
            batches.extend(group[i:i + unique_batch]
                           for i in range(0, len(group), unique_batch))
        yield from self._pipeline(
            batches, lambda pi: self.fused_item(pi, shots),
            num_workers, prefetch)

    # ---------------- the native route (C++ threads) -------------------
    def _use_native(self) -> bool:
        """Whether the epochs take the native route: uint8 inputs, as in
        the JAX package (float inputs are normalized on the host, by the
        numpy route).  Builds the C++ library at the first call; a failed
        build raises."""
        return self.uint8 and native.available()

    def _native_targets(self, recs, n_threads: int):
        """(canvases, info [N, 3] float32, scales [N] float64) of a
        canvas-homogeneous batch's records, as _prep_image makes them."""
        images = [self._read(r.image_path) for r in recs]
        target = (self.cfg.TRAIN.SCALES if self.training
                  else self.cfg.TEST.SCALES)[0]
        return native.prep_targets(
            images, np.array([r.flipped for r in recs], np.uint8), target,
            self._canvas_for(recs[0]), np.array(CANVAS_FILL, np.uint8),
            n_threads, s2d=self.host_s2d)

    def _native_queries(self, exemplars, flips, n_threads: int):
        """[N, q, q, 3] uint8: the exemplars' crops, as _prep_query makes
        them."""
        return native.prep_queries(
            [self._read(e.image_path) for e in exemplars],
            [e.box for e in exemplars], np.array(flips, np.uint8),
            self.query_size, n_threads)

    def _train_batch_native(self, idxs, n_threads: int):
        """A train batch on the native route; the draws in order first, as
        on the numpy route, so its metadata is the same."""
        draws = [self._train_draws(i) for i in idxs]
        queries = self._native_queries([d[1] for d in draws],
                                       [d[2] for d in draws], n_threads)
        canvases, info, scales = self._native_targets(
            [d[0] for d in draws], n_threads)
        gts = [self._gt_rows(d[3], d[4], float(s))
               for d, s in zip(draws, scales)]
        return {
            "image": canvases,
            "query": queries,
            "im_info": info,
            "gt_boxes": np.stack([g for g, _ in gts]),
            "num_boxes": np.array([n for _, n in gts], np.int32),
        }

    def _test_batch_native(self, idxs, n_threads: int):
        """An eval batch on the native route."""
        recs, exemplars = zip(*(self._test_exemplar(i) for i in idxs))
        queries = self._native_queries(exemplars, [False] * len(idxs),
                                       n_threads)
        canvases, info, _ = self._native_targets(recs, n_threads)
        pairs = [self.pairs[i] for i in idxs]
        return {
            "image": canvases,
            "query": queries,
            "im_info": info,
            "gt_boxes": np.zeros((len(idxs), self.max_gt, 5), np.float32),
            "num_boxes": np.zeros(len(idxs), np.int32),
            "pair_index": np.array(idxs, np.int32),
            "record_index": np.array([ri for ri, _ in pairs], np.int32),
            "category": np.array([c for _, c in pairs], np.int32),
        }

    # ------------------------------------------------------------------
    def _collate(self, items: List[Dict[str, np.ndarray]]):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def _orientation_groups(self, order, key_fn):
        """Split an index order into canvas-homogeneous groups."""
        if not self.portrait_bucket and not self.wide_buckets:
            return [order]
        groups: Dict[tuple, list] = {}
        for idx in order:
            groups.setdefault(key_fn(idx), []).append(idx)
        return list(groups.values())

    def _host_shard(self, batches: List[list], batch_size: int):
        """Each host keeps its interleaved 1/process_count slice of every
        global batch (canvas-homogeneity is preserved: all members of a
        batch share one canvas already)."""
        if self.process_count == 1:
            return batches
        if batch_size % self.process_count:
            raise ValueError(
                f"global batch {batch_size} must divide by process_count "
                f"{self.process_count}")
        return [b[self.process_index::self.process_count] for b in batches]

    def train_epoch(self, batch_size: int, *, num_workers: int = 8,
                    prefetch: int = 4) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled fixed-size batches; the tail wraps around (the reference
        sampler's leftover handling, trainval_net_voc.py:160-162).  With the
        portrait bucket, batches are canvas-homogeneous and the two shapes
        interleave in shuffled order.  `batch_size` is the GLOBAL batch; with
        process_count > 1 each host yields its batch_size/process_count
        slice."""
        order = self.order_rng.permutation(len(self)).tolist()
        batches = []
        for group in self._orientation_groups(
                order, lambda i: self._canvas_for(self.view.records[i])):
            pad = (-len(group)) % batch_size
            group = group + group[:pad]
            batches.extend(group[i:i + batch_size]
                           for i in range(0, len(group), batch_size))
        self.order_rng.shuffle(batches)
        yield from self._pipeline(
            self._host_shard(batches, batch_size), self._train_prepared,
            num_workers, prefetch, draw=self._train_draws,
            batch_fn=self._train_batch_native if self._use_native() else None)

    def test_epoch(self, batch_size: int, *, num_workers: int = 8,
                   prefetch: int = 4) -> Iterator[Dict[str, np.ndarray]]:
        """All (image, class) pairs in order; tail padded by repeating the
        last pair (consumers dedupe via 'pair_index').  `batch_size` is the
        GLOBAL batch; with process_count > 1 each host evaluates a disjoint
        slice of every batch (merge all_boxes across hosts by pair_index)."""
        order = list(range(len(self.pairs)))
        batches = []
        for group in self._orientation_groups(
                order,
                lambda i: self._canvas_for(
                    self.view.records[self.pairs[i][0]])):
            pad = (-len(group)) % batch_size
            group = group + [group[-1]] * pad
            batches.extend(group[i:i + batch_size]
                           for i in range(0, len(group), batch_size))
        yield from self._pipeline(
            self._host_shard(batches, batch_size), self.test_item,
            num_workers, prefetch,
            batch_fn=self._test_batch_native if self._use_native() else None)

    def _pipeline(self, batches, item_fn, num_workers, prefetch, draw=None,
                  batch_fn=None):
        """Collated batches of item_fn(draw(i)) (draw: the identity by
        default) over each batch's indices: the draws in order on one
        thread, item_fn on `num_workers` threads; or, on the native route,
        batch_fn(indices, num_workers), which draws in order and runs the
        pixel work on that many C++ threads (no Python pool)."""
        if not batches:
            return
        num_workers = max(1, num_workers)   # 0 = synchronous single worker
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stopped early takes nothing more: give up
            # instead of blocking on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        pool = (ThreadPoolExecutor(num_workers) if batch_fn is None
                else None)

        def make(idxs):
            if pool is None:
                return batch_fn(idxs, num_workers)
            if draw is not None:
                idxs = [draw(i) for i in idxs]
            return self._collate(list(pool.map(item_fn, idxs)))

        def producer():
            # any producer failure must reach the consumer — a dead
            # producer with an empty queue deadlocks q.get() forever
            try:
                for idxs in batches:
                    if stop.is_set() or not put(make(idxs)):
                        return
            except BaseException as e:  # noqa: BLE001
                put(e)
            else:
                put(None)
            finally:
                if pool is not None:
                    pool.shutdown()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join()
