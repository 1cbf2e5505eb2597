"""The port's data files (bigdl_tpu_torch/dataset/record_io.py,
sharded.py, seqfile.py, cifar.py) against the JAX package's, on the CPU.

- Bytes equal: CRC32C and its masked form on random bytes (the port's
  C++ library, its pure-Python path and both of JAX's), tf.Example,
  TFRecord files (either package's writer, the port's with and without
  its library), image shards and SequenceFiles; each package reads the
  other's files.
- Batches equal, per process: ``ShardedFileDataSet`` cached and
  streaming (a small shuffle buffer and the default 8192), 1 and 2
  processes, two epochs, on the port's threaded reader and on its
  pure-Python path.
- Equal to JAX's: ``restore_cursor`` (cached: the interrupted epoch's
  permutation; streaming: ignored), ``count_tfrecords`` on a truncated
  file, reader errors, CIFAR-10 binary and python files, ``cifar10_datasets``,
  and ``imagenet_tfrecord_dataset`` on ``.tfrecord`` and ``.seq`` shards.
- A cached run from shards, stopped at a checkpoint and resumed, ends
  bit-equal to the uninterrupted one.
"""
import os
import pickle
import struct

import numpy as np
import pytest

from bigdl_tpu import native as jnative
from bigdl_tpu.dataset import cifar as jcifar
from bigdl_tpu.dataset import seqfile as jseq
from bigdl_tpu.dataset import sharded as jsh
from bigdl_tpu.models import train_utils as jtrain_utils
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import cifar as tcifar
from bigdl_tpu_torch.dataset import record_io
from bigdl_tpu_torch.dataset import seqfile as tseq
from bigdl_tpu_torch.dataset import sharded as tsh
from bigdl_tpu_torch.models import train_utils as ttrain_utils
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger


@pytest.fixture(params=["native", "python"])
def reader(request, monkeypatch):
    """The port's record I/O with its C++ library, or without it (the
    pure-Python path)."""
    if request.param == "native":
        assert record_io.native_available()
    else:
        monkeypatch.setattr(record_io, "_load", lambda: None)
        assert not record_io.native_available()
    return request.param


def _images(n, size=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n, size, size, 3)).astype(np.uint8),
            rs.randint(0, 10, n))


def _batches(ds, train, n):
    it = ds.data(train=train)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.get_input(), w.get_input())
        np.testing.assert_array_equal(g.get_target(), w.get_target())


# --------------------------------------------------------------- bytes
def test_crc32c_equals_jax_native_and_python(reader):
    rs = np.random.RandomState(0)
    assert record_io.crc32c(b"123456789") == 0xE3069283
    assert record_io.crc32c(b"") == 0
    for n in (0, 1, 7, 8, 9, 1000, 100_003):
        data = rs.bytes(n)
        want = jnative.crc32c(data)
        assert record_io.crc32c(data) == want, n
        assert record_io.masked_crc32c(data) == jnative.masked_crc32c(data)
        # chained: a CRC continued from a prefix's
        assert record_io.crc32c(data[n // 2:], record_io.crc32c(
            data[:n // 2])) == want
    small = rs.bytes(3000)
    assert record_io.py_crc32c(small) == jnative.crc32c(small)
    assert record_io.py_masked_crc32c(small) == jnative.masked_crc32c(small)


def test_tf_example_bytes_equal_and_parse_both_ways():
    ex = {"image": b"\x00\x01\x02raw", "shape": np.asarray([2, 3, 4],
                                                           np.int64),
          "label": np.asarray([-1, 7], np.int64),
          "floats": np.asarray([1.5, -2.25], np.float32)}
    buf = tsh.encode_tf_example(ex)
    assert buf == jsh.encode_tf_example(ex)
    for out in (tsh.parse_tf_example(buf), jsh.parse_tf_example(buf)):
        assert out["image"] == ex["image"]
        for k in ("shape", "label", "floats"):
            np.testing.assert_array_equal(out[k], ex[k])
            assert out[k].dtype == ex[k].dtype


def test_tfrecord_files_bytes_equal_and_cross_read(tmp_path, reader):
    records = [b"hello", b"", os.urandom(10_000), b"world"]
    paths = {}
    for name, writer in (("port", record_io.TFRecordWriter),
                         ("jax", jnative.TFRecordWriter)):
        paths[name] = str(tmp_path / f"{name}.tfrecord")
        with writer(paths[name]) as w:
            for r in records:
                w.write(r)
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["port"] == raw["jax"]
    for p in paths.values():
        assert list(record_io.read_tfrecords(p)) == records
        assert list(jnative.read_tfrecords(p)) == records
        r = record_io.PrefetchingRecordReader([p])
        assert list(r) == records and list(r) == []  # one pass
        r.close()


def test_prefetching_reader_keeps_each_files_order(tmp_path, reader):
    paths = []
    for s in range(5):
        paths.append(str(tmp_path / f"s{s}.tfrecord"))
        with record_io.TFRecordWriter(paths[-1]) as w:
            for i in range(40):
                w.write(f"{s}:{i}".encode())
    r = record_io.PrefetchingRecordReader(paths, n_threads=3, capacity=4)
    got = [x.decode().split(":") for x in r]
    r.close()
    assert len(got) == 200
    for s in range(5):
        assert [int(i) for f, i in got if f == str(s)] == list(range(40))


def test_image_shards_bytes_equal(tmp_path, reader):
    images, labels = _images(10)
    tp = tsh.write_image_shards(str(tmp_path / "t"), images, labels, 3)
    jp = jsh.write_image_shards(str(tmp_path / "j"), images, labels, 3)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        assert open(a, "rb").read() == open(b, "rb").read()
    parse_t, parse_j = tsh.make_image_parser(6), jsh.make_image_parser(6)
    for rec in record_io.PrefetchingRecordReader(tp[:1]):
        (ti, tl), (ji, jl) = parse_t(rec), parse_j(rec)
        np.testing.assert_array_equal(ti, ji)
        assert ti.dtype == np.float32 and ti.shape == (6, 6, 3)
        assert tl == jl and tl.dtype == jl.dtype


def test_sequence_files_bytes_equal_and_cross_read(tmp_path):
    for v in (0, 1, -1, 127, -112, 128, -113, 65535, -65536, 2 ** 53):
        assert tseq.encode_vint(v) == jseq.encode_vint(v)
        assert tseq.decode_vint(jseq.encode_vint(v)) == (
            v, len(jseq.encode_vint(v)))
    images, labels = _images(12, size=9, seed=3)
    sync = bytes(range(16))
    paths = {}
    for name, mod in (("port", tseq), ("jax", jseq)):
        paths[name] = str(tmp_path / f"{name}.seq")
        with mod.SequenceFileWriter(paths[name], sync_marker=sync) as w:
            for i, (img, lab) in enumerate(zip(images, labels)):
                w.append(*mod.encode_imagenet_record(
                    img, int(lab) + 1, name=f"img{i}.JPEG" if i % 2 else None))
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    for p in paths.values():
        got, want = list(tseq.read_sequence_file(p)), \
            list(jseq.read_sequence_file(p))
        assert got == want and len(got) == 12
        assert tseq.count_sequence_file_records(p) == \
            jseq.count_sequence_file_records(p) == 12
        for (k, v), img, lab in zip(got, images, labels):
            t_img, t_lab, t_name = tseq.decode_imagenet_record(k, v)
            j_img, j_lab, j_name = jseq.decode_imagenet_record(k, v)
            np.testing.assert_array_equal(t_img, img)
            np.testing.assert_array_equal(t_img, j_img)
            assert t_lab == j_lab == lab + 1 and t_name == j_name
    with tseq.SequenceFileWriter(str(tmp_path / "b.seq"),
                                 key_class=tseq.BYTES_WRITABLE,
                                 value_class=tseq.BYTES_WRITABLE) as w:
        w.append(b"\x00\x01", b"payload")
    assert list(jseq.read_sequence_file(str(tmp_path / "b.seq"))) == \
        list(tseq.read_sequence_file(str(tmp_path / "b.seq"))) == \
        [(b"\x00\x01", b"payload")]


# ------------------------------------------------------------- batches
def _label_parser(buf):
    ex = jsh.parse_tf_example(buf)
    img = np.frombuffer(ex["image"], np.uint8).astype(np.float32)
    return img.reshape(tuple(int(v) for v in ex["shape"])), \
        np.int64(ex["label"][0])


def _shards(tmp_path, n=24, shards=4):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (n, 4, 4, 3), np.uint8)
    return tsh.write_image_shards(str(tmp_path), images, np.arange(n),
                                  shards)


@pytest.mark.parametrize("mode", ["cached", "stream8", "stream_default"])
@pytest.mark.parametrize("procs", [1, 2])
def test_sharded_batches_equal_jax_per_process(tmp_path, reader, mode,
                                               procs):
    paths = _shards(tmp_path, n=28)
    kw = dict(batch_size=4, seed=5, cache=mode == "cached",
              num_processes=procs)
    if mode == "stream8":
        kw["shuffle_buffer"] = 8
    for pid in range(procs):
        t = tsh.ShardedFileDataSet(paths, _label_parser, process_id=pid,
                                   **kw)
        j = jsh.ShardedFileDataSet(paths, _label_parser, process_id=pid,
                                   **kw)
        assert t.local_paths == j.local_paths
        assert t.local_size() == j.local_size()
        assert t.batches_per_epoch() == j.batches_per_epoch()
        n = 2 * t.batches_per_epoch()
        _same_batches(_batches(t, True, n), _batches(j, True, n))
        _same_batches(list(t.data(train=False)), list(j.data(train=False)))
        assert t.state_dict() == j.state_dict()


def test_cached_epochs_cover_every_record_once(tmp_path):
    paths = _shards(tmp_path, n=24)
    ds = tsh.ShardedFileDataSet(paths, _label_parser, batch_size=4)
    it = ds.data(train=True)
    for _ in range(2):
        labels = [int(v) for _ in range(ds.batches_per_epoch())
                  for v in next(it).get_target()]
        assert sorted(labels) == list(range(24))
    it.close()


@pytest.mark.parametrize("cache", [True, False])
def test_restore_cursor_equals_jax(tmp_path, cache):
    paths = _shards(tmp_path, n=24)
    kw = dict(batch_size=4, seed=1, cache=cache, shuffle_buffer=8)
    t = tsh.ShardedFileDataSet(paths, _label_parser, **kw)
    j = jsh.ShardedFileDataSet(paths, _label_parser, **kw)
    for ds in (t, j):
        ds.restore_cursor(1, 2)
    _same_batches(_batches(t, True, 10), _batches(j, True, 10))
    if cache:
        # the interrupted epoch's permutation: epoch 1 from its 3rd batch
        full = _batches(tsh.ShardedFileDataSet(paths, _label_parser, **kw),
                        True, 12)
        again = tsh.ShardedFileDataSet(paths, _label_parser, **kw)
        again.restore_cursor(1, 2)
        _same_batches(_batches(again, True, 4), full[8:12])


def test_count_tfrecords_on_a_truncated_file_equals_jax(tmp_path, reader):
    path = str(tmp_path / "t.tfrecord")
    with record_io.TFRecordWriter(path) as w:
        for _ in range(5):
            w.write(b"x" * 20)
    assert tsh.count_tfrecords(path) == jsh.count_tfrecords(path) == 5
    with open(path, "ab") as f:
        f.write(struct.pack("<Q", 100) + b"\x00" * 4 + b"y" * 10)
    assert tsh.count_tfrecords(path) == jsh.count_tfrecords(path) == 5
    # both sequential readers raise on the cut record
    for read in (record_io.read_tfrecords, jnative.read_tfrecords):
        with pytest.raises(IOError):
            list(read(path))


def test_reader_errors_equal_jax(tmp_path, reader):
    paths = _shards(tmp_path, n=24)

    def bad_reader(path):
        for i, rec in enumerate(jnative.read_tfrecords(path)):
            if i == 3:
                raise OSError("disk went away")
            yield rec

    for mod in (tsh, jsh):
        for cache in (True, False):
            ds = mod.ShardedFileDataSet(
                paths, _label_parser, batch_size=4, cache=cache,
                shuffle_buffer=1, record_reader=bad_reader,
                record_counter=lambda p: 6)
            with pytest.raises(OSError, match="disk went away"):
                for _ in ds.data(train=False):
                    pass
        with pytest.raises(FileNotFoundError):
            mod.ShardedFileDataSet([], _label_parser, batch_size=4)
        with pytest.raises(ValueError, match="not divisible"):
            mod.ShardedFileDataSet(paths, _label_parser, batch_size=5,
                                   num_processes=2)
        with pytest.raises(ValueError, match="0 of"):
            mod.ShardedFileDataSet(paths[:1], _label_parser, batch_size=4,
                                   process_id=1, num_processes=2)
    # a corrupt record: the sequential readers raise, the threaded ones
    # skip it and count it
    raw = bytearray(open(paths[0], "rb").read())
    raw[20] ^= 0xFF
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(raw))
    for read in (record_io.read_tfrecords, jnative.read_tfrecords):
        with pytest.raises(IOError, match="corrupt"):
            list(read(bad))
    tr = record_io.PrefetchingRecordReader([bad])
    jr = jnative.PrefetchingRecordReader([bad])
    if reader == "native":
        assert list(tr) == list(jr) and len(list(
            jnative.read_tfrecords(paths[0]))) == 6
        assert tr.crc_errors == jr.crc_errors == 1
    else:
        with pytest.raises(IOError):
            list(tr)
    tr.close()
    jr.close()


# --------------------------------------------------------------- CIFAR
def _write_cifar(root, layout, rs):
    os.makedirs(root, exist_ok=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for nm in names:
        n = 7
        labels = rs.randint(0, 10, n).astype(np.uint8)
        pixels = rs.randint(0, 256, (n, 3072)).astype(np.uint8)
        if layout == "bin":
            recs = np.concatenate([labels[:, None], pixels], axis=1)
            recs.tofile(os.path.join(root, nm + ".bin"))
        else:
            with open(os.path.join(root, nm), "wb") as f:
                pickle.dump({b"data": pixels, b"labels": labels.tolist()}, f)


@pytest.mark.parametrize("layout,sub", [("bin", "cifar-10-batches-bin"),
                                        ("py", "cifar-10-batches-py"),
                                        ("bin", "")])
def test_cifar_files_equal_jax(tmp_path, layout, sub):
    _write_cifar(str(tmp_path / sub) if sub else str(tmp_path), layout,
                 np.random.RandomState(2))
    for train in (True, False):
        tx, ty = tcifar.load_cifar10(str(tmp_path), train=train)
        jx, jy = jcifar.load_cifar10(str(tmp_path), train=train)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tx.shape == ((35 if train else 7), 32, 32, 3)
        assert tx.dtype == np.float32 and ty.dtype == np.int64
    with pytest.raises(FileNotFoundError):
        tcifar.load_cifar10(str(tmp_path / "none"))
    t_tr, t_va = ttrain_utils.cifar10_datasets(str(tmp_path), 5)
    j_tr, j_va = jtrain_utils.cifar10_datasets(str(tmp_path), 5)
    _same_batches(_batches(t_tr, True, 14), _batches(j_tr, True, 14))
    _same_batches(list(t_va.data(False)), list(j_va.data(False)))


def test_synthetic_cifar_and_constants_equal_jax():
    assert tcifar.TRAIN_MEAN == jcifar.TRAIN_MEAN
    assert tcifar.TRAIN_STD == jcifar.TRAIN_STD
    for train in (True, False):
        for a, b in zip(tcifar.load_cifar10(None, train, 50, seed=3),
                        jcifar.load_cifar10(None, train, 50, seed=3)):
            np.testing.assert_array_equal(a, b)
    t_tr, _ = ttrain_utils.cifar10_datasets(None, 8, synthetic_n=64)
    j_tr, _ = jtrain_utils.cifar10_datasets(None, 8, synthetic_n=64)
    _same_batches(_batches(t_tr, True, 10), _batches(j_tr, True, 10))


# ---------------------------------------------------- imagenet folders
def _imagenet_folder(root, fmt, n_train=20, n_val=8, size=10):
    images, labels = _images(n_train + n_val, size=size, seed=7)
    if fmt == "tfrecord":
        tsh.write_image_shards(root, images[:n_train], labels[:n_train], 4,
                               "train")
        tsh.write_image_shards(root, images[n_train:], labels[n_train:], 2,
                               "validation")
        return
    os.makedirs(root, exist_ok=True)
    for split, lo, hi, shards in (("train", 0, n_train, 4),
                                  ("validation", n_train, n_train + n_val,
                                   2)):
        for s in range(shards):
            path = os.path.join(root, f"{split}-{s:05d}.seq")
            with tseq.SequenceFileWriter(path) as w:
                for i in range(lo + s, hi, shards):
                    # BGR bytes, 1-based labels
                    w.append(*tseq.encode_imagenet_record(
                        images[i][:, :, ::-1], int(labels[i]) + 1))


@pytest.mark.parametrize("fmt", ["tfrecord", "seq"])
@pytest.mark.parametrize("cache", [True, False])
def test_imagenet_tfrecord_dataset_equals_jax(tmp_path, fmt, cache):
    _imagenet_folder(str(tmp_path), fmt)
    for split in ("train", "validation"):
        kw = dict(image_size=8, process_id=0, num_processes=1, seed=3,
                  cache=cache, shuffle_buffer=16)
        t = tsh.imagenet_tfrecord_dataset(str(tmp_path), split, 4, **kw)
        j = jsh.imagenet_tfrecord_dataset(str(tmp_path), split, 4, **kw)
        assert t.local_size() == j.local_size()
        _same_batches(_batches(t, True, 2 * t.batches_per_epoch()),
                      _batches(j, True, 2 * j.batches_per_epoch()))
        _same_batches(list(t.data(False)), list(j.data(False)))
    # the topology defaults to (0, 1) without a process group
    assert tsh.process_topology() == (0, 1)
    ds = tsh.imagenet_tfrecord_dataset(str(tmp_path), "train", 4,
                                       image_size=8)
    assert (ds.process_id, ds.num_processes) == (0, 1)
    with pytest.raises(FileNotFoundError):
        tsh.imagenet_tfrecord_dataset(str(tmp_path), "test", 4)


def test_seqfile_parser_equals_tfrecord_parser(tmp_path):
    """The same images as SequenceFile shards (BGR, 1-based) and as
    TFRecord shards (RGB, 0-based) give the same records."""
    _imagenet_folder(str(tmp_path / "seq"), "seq")
    _imagenet_folder(str(tmp_path / "tfr"), "tfrecord")
    kw = dict(image_size=8, process_id=0, num_processes=1)
    a = tsh.imagenet_tfrecord_dataset(str(tmp_path / "seq"), "train", 4,
                                      **kw)
    b = tsh.imagenet_tfrecord_dataset(str(tmp_path / "tfr"), "train", 4,
                                      **kw)
    # both write record i into shard i % 4: the same cached order
    _same_batches(list(a.data(False)), list(b.data(False)))


# ------------------------------------------------------ resume from disk
def _conv():
    return tnn.Sequential(
        tnn.SpatialConvolution(3, 4, 3, padding="SAME"),
        tnn.SpatialBatchNormalization(4), tnn.ReLU(),
        tnn.GlobalAveragePooling2D(), tnn.Linear(4, 10))


def _shard_run(paths, end, ckpt=None, resume=None):
    import torch

    torch.manual_seed(0)
    model = _conv()
    ds = tsh.ShardedFileDataSet(paths, tsh.make_image_parser(8), 4, seed=2)
    opt = (Optimizer.apply(model, ds, tnn.ClassNLLCriterion(logits=True),
                           end_trigger=Trigger.max_iteration(end),
                           device="cpu")
           .set_optim_method(SGD(0.1, momentum=0.9)))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.several_iteration(1))
    if resume is not None:
        opt.resume_from(str(resume))
    opt.optimize()
    return opt


@pytest.mark.parametrize("sync", ["0", "1"])
def test_a_resumed_cached_run_from_shards_equals_the_uninterrupted_one(
        tmp_path, monkeypatch, sync):
    monkeypatch.setenv("BIGDL_TPU_SYNC_LOOP", sync)
    images, labels = _images(20, size=8, seed=4)
    paths = tsh.write_image_shards(str(tmp_path / "d"), images, labels, 3)
    full = _shard_run(paths, 12)
    # 5 batches an epoch: stopped in epoch 2, two batches into it
    _shard_run(paths, 7, ckpt=tmp_path / "part")
    resumed = _shard_run(paths, 12, resume=tmp_path / "part" / "model")
    assert resumed._loop_state["loss"] == full._loop_state["loss"]
    for k, t in resumed.final_params.items():
        np.testing.assert_array_equal(t.numpy(),
                                      full.final_params[k].numpy(), k)
