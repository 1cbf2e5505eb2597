"""Sharded multi-process file input pipeline (counterpart of
bigdl_tpu/dataset/sharded.py; BigDL's CachedDistriDataSet,
dataset/DataSet.scala:247-316, and SeqFileFolder.files :539).

* Shards are TFRecord files read through the threaded prefetching reader
  (``dataset/record_io.py``), or SequenceFiles through
  ``dataset/seqfile.py``.
* Each process owns the shards ``sorted(paths)[process_id::n]`` and
  feeds only its slice of the global batch.
* Cached mode parses the records once into host memory and reshuffles
  their order every epoch with an epoch-salted seed (the same global
  epoch on every process, disjoint data).  Streaming mode
  (``cache=False``) reshuffles the shard order every pass, draws records
  through a shuffle buffer and assembles batches on a background thread.

tf.Example coding uses the port's protobuf wire helpers
(``utils/protowire.py``), with no TensorFlow.  Batches and their order
equal the JAX package's for the same shards and seed.
"""
from __future__ import annotations

import glob
import os
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.minibatch import MiniBatch
from bigdl_tpu_torch.dataset.prefetch import Prefetcher as _Prefetcher
from bigdl_tpu_torch.dataset.record_io import (PrefetchingRecordReader,
                                               TFRecordWriter)
from bigdl_tpu_torch.utils import protowire as pw

__all__ = ["ShardedFileDataSet", "count_tfrecords", "encode_tf_example",
           "imagenet_tfrecord_dataset", "make_image_parser",
           "make_seqfile_image_parser", "parse_tf_example",
           "process_topology", "write_image_shards"]


# ---------------------------------------------------------------------------
# TF Example encode / decode (tensorflow/core/example/example.proto)
# ---------------------------------------------------------------------------
def encode_tf_example(features: dict) -> bytes:
    """dict of {name: bytes | np.int array | np.float array} -> Example."""
    entries = b""
    for key, val in features.items():
        if isinstance(val, bytes):
            inner = pw.enc_bytes(1, pw.enc_bytes(1, val))  # bytes_list
        else:
            arr = np.asarray(val)
            if np.issubdtype(arr.dtype, np.integer):
                body = b"".join(pw.enc_varint(int(v) & (2 ** 64 - 1))
                                for v in arr.reshape(-1))
                inner = pw.enc_bytes(3, pw.enc_bytes(1, body))  # int64_list
            else:
                body = arr.astype("<f4").tobytes()
                inner = pw.enc_bytes(2, pw.enc_bytes(1, body))  # float_list
        feature = inner
        entry = pw.enc_str(1, key) + pw.enc_bytes(2, feature)
        entries += pw.enc_bytes(1, entry)
    return pw.enc_bytes(1, entries)  # Example.features


def parse_tf_example(buf: bytes) -> dict:
    """Example -> {name: bytes | np.int64 array | np.float32 array}."""
    ex = pw.fields(buf)
    features = pw.get_message(ex, 1)
    out = {}
    for entry_f in pw.get_messages(features, 1):
        key = pw.get_str(entry_f, 1)
        feat = pw.get_message(entry_f, 2)
        if feat is None:
            continue
        blist = pw.get_message(feat, 1)
        flist = pw.get_message(feat, 2)
        ilist = pw.get_message(feat, 3)
        if blist is not None:
            vals = pw.get_bytes(blist, 1)
            out[key] = vals[0] if len(vals) == 1 else vals
        elif flist is not None:
            raw = pw.get_bytes(flist, 1)
            if raw:  # packed
                out[key] = np.frombuffer(b"".join(raw), dtype="<f4")
            else:
                out[key] = np.asarray(pw.get_floats(flist, 1), np.float32)
        elif ilist is not None:
            # signed: encode writes two's-complement varints, so -1 must
            # not come back as 2**64-1 (OverflowError at np.int64)
            out[key] = np.asarray(
                pw.get_ints(ilist, 1, signed=True), np.int64)
    return out


# ---------------------------------------------------------------------------
# Sharded dataset
# ---------------------------------------------------------------------------
def process_topology() -> Tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed``
    process group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def count_tfrecords(path: str) -> int:
    """Record count by header seeks — no payload reads, no CRC."""
    import struct

    n = 0
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 12 <= size:
            hdr = f.read(12)
            if len(hdr) < 12:
                break
            (length,) = struct.unpack("<Q", hdr[:8])
            pos += 12 + length + 4
            if pos > size:  # truncated final record: not a real record
                break
            f.seek(pos)
            n += 1
    return n


class ShardedFileDataSet(AbstractDataSet):
    """TFRecord shards -> per-host cached records -> fixed-shape batches.

    ``parse_record(bytes) -> (feature ndarray, label ndarray)``.
    ``batch_size`` is GLOBAL; this host yields ``batch_size //
    num_processes`` records per step, mirroring ``DistributedDataSet``.
    """

    def __init__(
        self,
        shard_paths: Sequence[str],
        parse_record: Callable[[bytes], Tuple[np.ndarray, np.ndarray]],
        batch_size: int,
        process_id: int = 0,
        num_processes: int = 1,
        seed: int = 0,
        cache: bool = True,
        record_reader: Optional[Callable[[str], Iterable]] = None,
        shuffle_buffer: int = 8192,
        record_counter: Optional[Callable[[str], int]] = None,
    ):
        paths = sorted(shard_paths)
        if not paths:
            raise FileNotFoundError("no shards given")
        if batch_size % num_processes != 0:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"{num_processes} processes")
        self.all_paths = paths
        self.local_paths = paths[process_id::num_processes]
        if not self.local_paths:
            raise ValueError(
                f"host {process_id}/{num_processes} got 0 of "
                f"{len(paths)} shards — need >= one shard per host")
        self.parse_record = parse_record
        # record_reader(path) -> iterable of raw records; default is the
        # native TFRecord reader.  Pass seqfile.read_sequence_file to
        # train from reference-produced Hadoop SequenceFile shards.
        self.record_reader = record_reader
        # record_counter(path) -> record count without decoding payloads
        # (streaming batches_per_epoch); defaults to the TFRecord header
        # walker, or a full read when only a custom reader is given
        self.record_counter = record_counter
        self.batch_size = batch_size
        self.local_batch = batch_size // num_processes
        self.process_id = process_id
        self.num_processes = num_processes
        self.seed = seed
        self.cache = cache
        # streaming mode keeps at most shuffle_buffer parsed records +
        # a couple of assembled batches in memory
        self.shuffle_buffer = max(1, shuffle_buffer)
        self._records: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
        self._stream_count: Optional[int] = None
        self._epoch = 0
        self._order: Optional[np.ndarray] = None
        self._skip = 0  # batches to drop on the next cached train pass

    # -- loading -------------------------------------------------------
    def _load(self):
        if self._records is not None:
            return
        # per-shard record lists concatenated in path order: shards load
        # CONCURRENTLY but the cached order stays deterministic (the
        # multi-file prefetching reader interleaves shards in
        # thread-dependent order, which would desync same-seed epochs
        # across processes)
        from concurrent.futures import ThreadPoolExecutor

        def load_one(path):
            return [self.parse_record(r) for r in self._iter_shard(path)]

        with ThreadPoolExecutor(max_workers=min(8, len(self.local_paths))) \
                as pool:
            per_shard = list(pool.map(load_one, self.local_paths))
        self._records = [rec for shard in per_shard for rec in shard]
        if not self._records:
            raise ValueError(f"shards {self.local_paths} contain 0 records")
        self._order = np.arange(len(self._records))

    # -- streaming mode (cache=False) ---------------------------------
    # ImageNet-scale shard sets do not fit host RAM; the streaming path
    # reshuffles the shard order each pass, runs records through a
    # reservoir-style shuffle buffer, and assembles fixed-shape batches
    # on a background prefetch thread so host IO overlaps device compute
    # (the role the reference's MTLabeledBGRImgToBatch threads played).
    def _iter_shard(self, path: str):
        """Raw records of one shard via the configured reader."""
        if self.record_reader is not None:
            yield from self.record_reader(path)
            return
        reader = PrefetchingRecordReader([path])
        try:
            yield from reader
        finally:
            reader.close()

    def _count_local_records(self) -> int:
        if self._stream_count is not None:
            return self._stream_count

        def count_one(path: str) -> int:
            if self.record_counter is not None:
                return self.record_counter(path)
            if self.record_reader is not None:
                return sum(1 for _ in self.record_reader(path))
            return count_tfrecords(path)

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
                max_workers=min(8, len(self.local_paths))) as pool:
            self._stream_count = sum(pool.map(count_one, self.local_paths))
        if not self._stream_count:
            raise ValueError(f"shards {self.local_paths} contain 0 records")
        return self._stream_count

    def _record_stream(self, loop: bool):
        epoch = 0
        while True:
            rs = np.random.RandomState(
                (self.seed + epoch) * 2654435761 % (2 ** 31))
            order = (rs.permutation(len(self.local_paths)) if loop
                     else np.arange(len(self.local_paths)))
            for si in order:
                for rec in self._iter_shard(self.local_paths[int(si)]):
                    yield self.parse_record(rec)
            if not loop:
                return
            epoch += 1

    def _stream_batches(self, train: bool) -> Iterator[MiniBatch]:
        self._count_local_records()  # raises on empty shards up front
        lb = self.local_batch

        def emit(items):
            return MiniBatch(np.stack([f for f, _ in items]),
                             np.stack([l for _, l in items]))

        if not train:
            batch: List = []
            for rec in self._record_stream(loop=False):
                batch.append(rec)
                if len(batch) == lb:
                    yield emit(batch)
                    batch = []
            if batch:
                yield emit(batch)
            return
        rs = np.random.RandomState(self.seed ^ 0x5EED5EED)
        buf: List = []
        pending: List = []
        for rec in self._record_stream(loop=True):
            buf.append(rec)
            if len(buf) < self.shuffle_buffer:
                continue
            j = rs.randint(len(buf))
            buf[j], buf[-1] = buf[-1], buf[j]
            pending.append(buf.pop())
            if len(pending) == lb:
                yield emit(pending)
                pending = []

    # -- AbstractDataSet ----------------------------------------------
    def size(self) -> int:
        return self.local_size() * self.num_processes  # approx global

    def local_size(self) -> int:
        if not self.cache:
            return self._count_local_records()
        self._load()
        return len(self._records)

    def batches_per_epoch(self) -> int:
        return max(1, self.local_size() // self.local_batch)

    def shuffle(self):
        """Epoch-salted reshuffle of the cached record order
        (CachedDistriDataSet.shuffle, DataSet.scala:299)."""
        if not self.cache:
            return  # streaming shuffles via shard order + buffer
        self._load()
        rs = np.random.RandomState(
            (self.seed + self._epoch) * 2654435761 % (2 ** 31))
        self._order = rs.permutation(len(self._records))
        self._epoch += 1

    def state_dict(self):
        return {"epoch": self._epoch, "seed": self.seed,
                "cache": self.cache}

    def restore_cursor(self, epoch, batch_in_epoch=0):
        """Rewind to driver-epoch ``epoch``: the cached train loop calls
        shuffle() FIRST each pass (order seeded from ``_epoch``, then
        incremented), so setting ``_epoch = epoch`` regenerates exactly
        the permutation the original pass used.  Streaming mode
        (``cache=False``) cannot replay — the reservoir shuffle depends
        on arrival order — so the cursor is best-effort ignored there
        (docs/distributed.md documents the caveat)."""
        if not self.cache:
            return
        self._epoch = int(epoch)
        self._skip = int(batch_in_epoch)

    def data(self, train: bool) -> Iterator[MiniBatch]:
        if not self.cache:
            p = _Prefetcher(self._stream_batches(train))
            try:
                yield from p
            finally:
                # abandoning the (possibly infinite) train iterator must
                # stop the producer thread and its open shard readers
                p.close()
            return
        self._load()
        lb = self.local_batch

        def emit(idx):
            feats = np.stack([self._records[i][0] for i in idx])
            labels = np.stack([self._records[i][1] for i in idx])
            return MiniBatch(feats, labels)

        if not train:
            # evaluation: deterministic order, NO wrap-around fill (that
            # would double-count records in metrics) — the tail comes out
            # as one short batch.  Distributed eval callers should pick
            # local_batch | local_size to keep shapes static.
            order = np.arange(len(self._records))
            for b in range(0, len(order), lb):
                yield emit(order[b:b + lb])
            return
        while True:
            self.shuffle()
            start, self._skip = self._skip, 0
            for b in range(start, self.batches_per_epoch()):
                idx = self._order[b * lb:(b + 1) * lb]
                if len(idx) < lb:  # wrap-around fill: fixed shapes always
                    idx = np.concatenate([idx, self._order[: lb - len(idx)]])
                yield emit(idx)


# ---------------------------------------------------------------------------
# ImageNet-style record helpers (the SeqFileFolder/ImageNetSeqFileGenerator
# analogs, models/utils/ImageNetSeqFileGenerator.scala)
# ---------------------------------------------------------------------------
def write_image_shards(
    out_dir: str,
    images: np.ndarray,   # (N, H, W, 3) uint8
    labels: np.ndarray,   # (N,)
    n_shards: int,
    prefix: str = "train",
) -> List[str]:
    """Write (image, label) TFRecord shards: raw uint8 HWC + int label."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    n = len(images)
    for s in range(n_shards):
        path = os.path.join(
            out_dir, f"{prefix}-{s:05d}-of-{n_shards:05d}.tfrecord")
        with TFRecordWriter(path) as w:
            for i in range(s, n, n_shards):
                w.write(encode_tf_example({
                    "image": images[i].astype(np.uint8).tobytes(),
                    "shape": np.asarray(images[i].shape, np.int64),
                    "label": np.asarray([labels[i]], np.int64),
                }))
        paths.append(path)
    return paths


_IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _finish_image(img: np.ndarray, image_size: int,
                  normalize: bool) -> np.ndarray:
    """uint8 RGB -> float32 (image_size, image_size, 3), center-crop/pad
    + optional ImageNet normalization (host-side; the full augmentation
    stack lives in transform/vision)."""
    img = img.astype(np.float32) / 255.0
    if img.shape[:2] != (image_size, image_size):
        h, w = img.shape[:2]
        oh = max((h - image_size) // 2, 0)
        ow = max((w - image_size) // 2, 0)
        img = img[oh:oh + image_size, ow:ow + image_size]
        ph, pw_ = image_size - img.shape[0], image_size - img.shape[1]
        if ph or pw_:
            img = np.pad(img, ((0, ph), (0, pw_), (0, 0)))
    if normalize:
        img = (img - _IMAGENET_MEAN) / _IMAGENET_STD
    return img


def make_image_parser(image_size: int, normalize: bool = True):
    def parse(buf: bytes):
        ex = parse_tf_example(buf)
        shape = tuple(int(v) for v in ex["shape"])
        img = np.frombuffer(ex["image"], np.uint8).reshape(shape)
        return (_finish_image(img, image_size, normalize),
                np.int64(ex["label"][0]))

    return parse


def make_seqfile_image_parser(image_size: int, normalize: bool = True):
    """Parser over BigDL-layout SequenceFile records (BGR bytes, 1-based
    Torch-style labels: dataset/seqfile.py); converts to RGB and 0-based
    labels."""
    from bigdl_tpu_torch.dataset.seqfile import decode_imagenet_record

    def parse(item):
        img_bgr, label, _ = decode_imagenet_record(*item)
        return (_finish_image(img_bgr[:, :, ::-1], image_size, normalize),
                np.int64(label - 1))

    return parse


def imagenet_tfrecord_dataset(
    folder: str,
    split: str,
    batch_size: int,
    image_size: int = 224,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    seed: int = 0,
    cache: bool = True,
    shuffle_buffer: int = 8192,
) -> ShardedFileDataSet:
    """Build the sharded ImageNet dataset from ``folder/split-*`` shards.
    The process topology defaults to :func:`process_topology`.

    ``.seq`` shards (BigDL-produced Hadoop SequenceFiles) are detected by
    extension and read through the SequenceFile codec."""
    if process_id is None or num_processes is None:
        process_id, num_processes = process_topology()
    paths = sorted(glob.glob(os.path.join(folder, f"{split}-*")))
    if not paths:
        raise FileNotFoundError(f"no '{split}-*' shards under {folder}")
    reader = None
    counter = None
    parser = make_image_parser(image_size)
    if paths[0].endswith(".seq"):
        from bigdl_tpu_torch.dataset.seqfile import (
            count_sequence_file_records, read_sequence_file)

        reader = read_sequence_file
        counter = count_sequence_file_records
        parser = make_seqfile_image_parser(image_size)
    return ShardedFileDataSet(
        paths,
        parser,
        batch_size,
        process_id=process_id,
        num_processes=num_processes,
        seed=seed,
        cache=cache,
        record_reader=reader,
        shuffle_buffer=shuffle_buffer,
        record_counter=counter,
    )
