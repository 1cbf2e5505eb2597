"""Table ops (counterpart of bigdl_tpu/nn/table_ops.py)."""
from __future__ import annotations

from bigdl_tpu_torch.nn.module import Module


class CAddTable(Module):
    """Elementwise sum of the inputs (the residual add)."""

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
