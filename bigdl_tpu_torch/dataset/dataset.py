"""DataSet abstractions (counterpart of bigdl_tpu/dataset/dataset.py:
33-160, 220-302).

:class:`LocalArrayDataSet` is the whole-array in-memory dataset with
vectorised batch assembly.  ``data(train=True)`` yields MiniBatches
forever, reshuffling after each pass with ``RandomState(seed + epoch)``,
so the port and the JAX package see the same batches in the same order;
``data(train=False)`` yields one pass in order.  ``restore_cursor``
rewinds the training stream to a checkpoint's (epoch, batch), so that a
resumed run reads the batches the uninterrupted one would have.

:class:`DistributedDataSet` is one rank's view of a dataset every rank
builds alike (``DataSet.sharded``): rows ``[r * b / n, (r + 1) * b / n)``
of each global batch.  Its cursor is the shared base's, so a world
re-formed at another size replays the same global batch stream, each
rank taking a wider or narrower slice of it.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from bigdl_tpu_torch.dataset.minibatch import MiniBatch


class AbstractDataSet:
    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        """Advance the epoch permutation."""

    def data(self, train: bool) -> Iterator[MiniBatch]:
        raise NotImplementedError

    def batches_per_epoch(self) -> int:
        raise NotImplementedError


class LocalArrayDataSet(AbstractDataSet):
    """Vectorised in-memory dataset over stacked feature/label arrays.
    With ``drop_remainder`` (the default) a last batch short of
    ``batch_size`` is dropped, so batches keep one shape; without it the
    short batch ends each pass."""

    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray],
                 batch_size: int, seed: int = 0,
                 drop_remainder: bool = True):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels) if labels is not None else None
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.drop_remainder = drop_remainder
        self._perm = np.arange(self.features.shape[0])
        self._skip = 0  # batches to drop on the next training pass

    def size(self):
        return self.features.shape[0]

    def batches_per_epoch(self):
        n, bs = self.size(), self.batch_size
        return n // bs if self.drop_remainder else -(-n // bs)

    def shuffle(self):
        self.epoch += 1
        rng = np.random.RandomState(self.seed + self.epoch)
        self._perm = rng.permutation(self.size())

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "seed": self.seed,
                "batch_size": self.batch_size}

    def restore_cursor(self, epoch: int, batch_in_epoch: int = 0):
        """Rewind to batch ``batch_in_epoch`` of epoch ``epoch``: the
        epoch's permutation regenerated from ``seed + epoch`` (epoch 0 is
        the identity), and the batches before it skipped on the next
        training pass (bigdl_tpu/dataset/dataset.py:123-140)."""
        self.epoch = int(epoch)
        if self.epoch == 0:
            self._perm = np.arange(self.size())
        else:
            self._perm = np.random.RandomState(
                self.seed + self.epoch).permutation(self.size())
        self._skip = int(batch_in_epoch)

    def data(self, train: bool) -> Iterator[MiniBatch]:
        if train:
            while True:
                skip, self._skip = self._skip, 0
                yield from self._one_pass(skip)
                self.shuffle()
        else:
            yield from self._one_pass()

    def _one_pass(self, start_batch: int = 0):
        n, bs = self.size(), self.batch_size
        stop = (n // bs) * bs if self.drop_remainder else n
        for i in range(start_batch * bs, stop, bs):
            idx = self._perm[i:i + bs]
            yield MiniBatch(self.features[idx],
                            self.labels[idx] if self.labels is not None
                            else None)


class DistributedDataSet(AbstractDataSet):
    """This process's slice of every global batch of ``base``, which
    every process builds over the same data with the same ``seed``, so
    that the slices partition each batch (dataset.py:220-273)."""

    def __init__(self, base: LocalArrayDataSet, process_id: int,
                 num_processes: int):
        if base.batch_size % num_processes != 0:
            raise ValueError(
                f"global batch_size {base.batch_size} must be divisible by "
                f"num_processes {num_processes} (otherwise records are "
                f"silently dropped from every batch)")
        self.base = base
        self.process_id = process_id
        self.num_processes = num_processes

    def size(self):
        return self.base.size()

    def local_size(self):
        return self.base.size() // self.num_processes

    def batches_per_epoch(self):
        return self.base.batches_per_epoch()

    def shuffle(self):
        self.base.shuffle()

    def state_dict(self):
        return self.base.state_dict()

    def restore_cursor(self, epoch: int, batch_in_epoch: int = 0):
        """The cursor lives in the shared base: every process rewinds
        the same global permutation, so a world of another size replays
        the same global batches (dataset.py:254-259)."""
        self.base.restore_cursor(epoch, batch_in_epoch)

    def data(self, train: bool) -> Iterator[MiniBatch]:
        per_host = self.base.batch_size // self.num_processes
        off = self.process_id * per_host
        for batch in self.base.data(train):
            yield batch.slice(off, per_host)


class DataSet:
    """Factory facade (reference object DataSet)."""

    @staticmethod
    def from_arrays(features: np.ndarray, labels: Optional[np.ndarray] = None,
                    batch_size: int = 32, seed: int = 0) -> LocalArrayDataSet:
        return LocalArrayDataSet(features, labels, batch_size, seed)

    @staticmethod
    def sharded(features: np.ndarray, labels: Optional[np.ndarray],
                batch_size: int, process_id: int = 0,
                num_processes: int = 1, seed: int = 0) -> AbstractDataSet:
        """This process's view of a global-batch stream: the whole
        dataset for one process, else a :class:`DistributedDataSet`
        (dataset.py:288-302)."""
        base = LocalArrayDataSet(features, labels, batch_size, seed)
        if num_processes == 1:
            return base
        return DistributedDataSet(base, process_id, num_processes)
