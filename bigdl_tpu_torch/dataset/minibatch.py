"""MiniBatch (counterpart of bigdl_tpu/dataset/minibatch.py:31-58):
batched features and targets as numpy arrays (or lists of them for
multi-input models); the training loop moves them to the device."""
from __future__ import annotations


class MiniBatch:
    def __init__(self, features, targets=None):
        self.features = features
        self.targets = targets

    @property
    def size(self) -> int:
        f = self.features[0] if isinstance(self.features, list) \
            else self.features
        return f.shape[0]

    def get_input(self):
        return self.features

    def get_target(self):
        return self.targets
