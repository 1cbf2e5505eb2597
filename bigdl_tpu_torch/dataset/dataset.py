"""DataSet abstractions (counterpart of bigdl_tpu/dataset/dataset.py:
33-160, 282-288).

:class:`LocalArrayDataSet` is the whole-array in-memory dataset with
vectorised batch assembly.  ``data(train=True)`` yields MiniBatches
forever, reshuffling after each pass with ``RandomState(seed + epoch)``,
so the port and the JAX package see the same batches in the same order;
``data(train=False)`` yields one pass in order.  ``restore_cursor``
rewinds the training stream to a checkpoint's (epoch, batch), so that a
resumed run reads the batches the uninterrupted one would have.
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
    """Vectorised in-memory dataset over stacked feature/label arrays;
    a last batch short of ``batch_size`` is dropped (batches keep one
    shape)."""

    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray],
                 batch_size: int, seed: int = 0):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels) if labels is not None else None
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self._perm = np.arange(self.features.shape[0])
        self._skip = 0  # batches to drop on the next training pass

    def size(self):
        return self.features.shape[0]

    def batches_per_epoch(self):
        return self.size() // self.batch_size

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
        bs = self.batch_size
        for i in range(start_batch * bs, self.batches_per_epoch() * bs, bs):
            idx = self._perm[i:i + bs]
            yield MiniBatch(self.features[idx],
                            self.labels[idx] if self.labels is not None
                            else None)


class DataSet:
    """Factory facade (reference object DataSet)."""

    @staticmethod
    def from_arrays(features: np.ndarray, labels: Optional[np.ndarray] = None,
                    batch_size: int = 32, seed: int = 0) -> LocalArrayDataSet:
        return LocalArrayDataSet(features, labels, batch_size, seed)
