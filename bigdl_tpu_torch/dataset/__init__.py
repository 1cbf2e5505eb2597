"""Datasets of the port (counterpart of bigdl_tpu.dataset)."""
from bigdl_tpu_torch.dataset.cifar import (TRAIN_MEAN, TRAIN_STD,
                                           load_cifar10, synthetic_cifar10)
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             DistributedDataSet,
                                             LocalArrayDataSet)
from bigdl_tpu_torch.dataset.minibatch import MiniBatch
from bigdl_tpu_torch.dataset.record_io import (PrefetchingRecordReader,
                                               TFRecordWriter, crc32c,
                                               masked_crc32c,
                                               native_available,
                                               read_tfrecords)
from bigdl_tpu_torch.dataset.seqfile import (SequenceFileWriter,
                                             count_sequence_file_records,
                                             decode_imagenet_record,
                                             encode_imagenet_record,
                                             read_sequence_file)
from bigdl_tpu_torch.dataset.sharded import (ShardedFileDataSet,
                                             count_tfrecords,
                                             encode_tf_example,
                                             imagenet_tfrecord_dataset,
                                             make_image_parser,
                                             make_seqfile_image_parser,
                                             parse_tf_example,
                                             write_image_shards)

__all__ = ["AbstractDataSet", "DataSet", "DistributedDataSet",
           "LocalArrayDataSet", "MiniBatch",
           "PrefetchingRecordReader", "SequenceFileWriter",
           "ShardedFileDataSet", "TFRecordWriter", "TRAIN_MEAN", "TRAIN_STD",
           "count_sequence_file_records", "count_tfrecords", "crc32c",
           "decode_imagenet_record", "encode_imagenet_record",
           "encode_tf_example", "imagenet_tfrecord_dataset", "load_cifar10",
           "make_image_parser", "make_seqfile_image_parser",
           "masked_crc32c", "native_available", "parse_tf_example",
           "read_sequence_file", "read_tfrecords", "synthetic_cifar10",
           "write_image_shards"]
