"""The sparse gradient path of embedding training (counterpart of
bigdl_tpu/optim/sparse_update.py).

The reference trains a LookupTable from a COO SparseTensor with sparse
update rules (tensor/SparseTensor.scala, SparseTensorBLAS.scala:461,
DenseSparseAdagrad), so a large vocabulary never gets a dense (vocab,
dim) gradient.  Here, as in the JAX package, the gradient of a lookup is
``(indices, rows)``:

* duplicate indices are summed by a stable sort and a segment sum
  (fixed shapes: the result is padded back to the input's length with
  ``n_rows`` sentinels, so a CUDA graph replays it);
* only the touched rows of the table (and of Adagrad's accumulator) are
  updated; a sentinel's update is dropped (``mode="drop"``: the table is
  extended by one scratch row that is cut off again).

:func:`make_sparse_embedding_train_step` builds the step of a
``Sequential`` whose first child is a ``LookupTable``: the table's
gradient is taken with respect to the looked-up rows, so the work per
step scales with the batch, not the vocabulary.  Its ``padding_value``
rows embed to zero and get no gradient; a ``max_norm`` table is refused
(its renormalisation reads every row).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.func import functional_call

from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.utils.convert import subtree

__all__ = ["SparseAdagrad", "SparseRows", "SparseSGD",
           "make_sparse_embedding_train_step", "row_aggregate",
           "scatter_rows_add"]


class SparseRows(NamedTuple):
    """A row-sparse gradient: ``values[i]`` belongs to row ``indices[i]``
    of an ``(n_rows, dim)`` parameter; ``indices == n_rows`` marks
    padding (dropped by a scatter)."""

    indices: torch.Tensor  # (k,) int64
    values: torch.Tensor   # (k, dim)
    n_rows: int


def row_aggregate(indices: torch.Tensor, values: torch.Tensor,
                  n_rows: int) -> SparseRows:
    """Duplicate rows summed: a stable sort, then a segment sum over the
    batch; the result is padded back to the input's length with
    ``n_rows`` sentinels.  Summing before the update keeps Adagrad exact:
    its accumulator sees ``(sum of g)^2``, not the sum of squares."""
    idx = indices.reshape(-1).long()
    vals = values.reshape(idx.shape[0], -1)
    order = torch.argsort(idx, stable=True)
    si, sv = idx[order], vals[order]
    new_seg = torch.cat([torch.zeros(1, dtype=torch.long,
                                     device=idx.device),
                         (si[1:] != si[:-1]).long()])
    seg = torch.cumsum(new_seg, 0)
    k = idx.shape[0]
    agg = torch.zeros((k, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device).index_add_(0, seg, sv)
    # a representative index per segment; untouched segments pad
    seg_idx = torch.full((k,), n_rows, dtype=torch.long,
                         device=idx.device).scatter_(0, seg, si)
    return SparseRows(seg_idx, agg, n_rows)


def _scatter_add(table: torch.Tensor, indices: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``table`` with ``rows`` added at ``indices``; an index of
    ``len(table)`` is dropped."""
    ext = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    return ext.index_add_(0, indices, rows)[:table.shape[0]]


def scatter_rows_add(table: torch.Tensor, rows: SparseRows,
                     scale=1.0) -> torch.Tensor:
    """``table[rows.indices] += scale * rows.values`` (padding
    dropped)."""
    return _scatter_add(table, rows.indices,
                        (scale * rows.values).to(table.dtype))


class SparseSGD(OptimMethod):
    """SGD over row-sparse gradients: only the batch's rows change (no
    momentum: a dense velocity would defeat the point)."""

    def __init__(self, learning_rate: float = 1e-2, schedule=None):
        super().__init__(learning_rate, schedule)

    def init_state(self, params):
        return {}

    @torch.no_grad()
    def update(self, grads: SparseRows, opt_state, params, lr, step=None):
        return scatter_rows_add(params, grads, scale=-lr), opt_state


class SparseAdagrad(OptimMethod):
    """Adagrad whose accumulator update and read touch only the batch's
    rows (the reference's sparse Adagrad).  The accumulator is ``(n_rows,
    dim)`` state, as dense Adagrad's; the work per step is the batch's
    rows."""

    def __init__(self, learning_rate: float = 1e-2, eps: float = 1e-10,
                 schedule=None):
        super().__init__(learning_rate, schedule)
        self.eps = eps

    def init_state(self, params):
        return {"accum": torch.zeros(params.shape, dtype=torch.float32,
                                     device=params.device)}

    @torch.no_grad()
    def update(self, grads: SparseRows, opt_state, params, lr, step=None):
        g = grads.values.float()
        accum = _scatter_add(opt_state["accum"], grads.indices, g * g)
        # a sentinel reads the scratch row: its value is 0 and its update
        # is dropped
        ext = torch.cat([accum, accum.new_zeros((1,) + tuple(
            accum.shape[1:]))])
        denom = torch.sqrt(ext[grads.indices] + self.eps)
        step_rows = SparseRows(grads.indices, g / denom, grads.n_rows)
        return scatter_rows_add(params, step_rows, scale=-lr), \
            {"accum": accum}


def make_sparse_embedding_train_step(model: torch.nn.Module, criterion,
                                     table_method: OptimMethod,
                                     rest_method: OptimMethod):
    """The train step of ``Sequential(LookupTable, rest...)`` whose table
    is updated from row-sparse gradients:

    ``step(params, model_state, opt_states, step_i, rng, idx, targets,
    (table_lr, rest_lr)) -> (params', model_state', opt_states', loss)``

    over flat dicts keyed as ``named_parameters``/``named_buffers``;
    ``opt_states = {"table": ..., "rest": ...}`` (the rest's state keyed
    by the rest's parameter names).  ``rng`` is accepted for the step's
    signature."""
    emb_key = model.child_keys[0]
    emb = getattr(model, emb_key)
    n_rows = emb.n_index
    if getattr(emb, "max_norm", None) is not None:
        raise ValueError(
            "sparse embedding step does not support max_norm (the renorm "
            "reads every row — dense by construction); drop max_norm or "
            "use the dense train step")
    padding_value = getattr(emb, "padding_value", None)
    table_key = f"{emb_key}.weight"
    rest_keys = model.child_keys[1:]

    def rest_apply(rest_params: Dict[str, torch.Tensor], state, x):
        for k in rest_keys:
            x = functional_call(getattr(model, k),
                                {**subtree(rest_params, k),
                                 **subtree(state, k)}, (x,))
        return x

    def step(params, model_state, opt_states, step_i, rng, idx, targets,
             lrs):
        model.train()
        table = params[table_key]
        idx = idx.long()
        rest_params = {k: v for k, v in params.items() if k != table_key}
        new_state = {k: v.clone() for k, v in model_state.items()}
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in rest_params.items()}
        looked = table.detach()[idx].requires_grad_(True)
        with torch.enable_grad():
            emb_out = looked
            if padding_value is not None:
                # the lookup's own masking, inside the differentiated
                # function, so pad positions get no gradient either
                emb_out = torch.where((idx != padding_value)[..., None],
                                      emb_out, torch.zeros_like(emb_out))
            out = rest_apply(leaves, new_state, emb_out)
            loss = criterion.forward(out, targets).float()
            grads = torch.autograd.grad(loss,
                                        list(leaves.values()) + [looked])
        g_rest = dict(zip(leaves, grads[:-1]))
        rows = row_aggregate(idx, grads[-1], n_rows)
        table_lr, rest_lr = lrs
        new_table, t_state = table_method.update(
            rows, opt_states["table"], table, table_lr, step_i)
        new_rest, r_state = rest_method.update(
            g_rest, opt_states["rest"], rest_params, rest_lr, step_i)
        new_params = dict(new_rest)
        new_params[table_key] = new_table
        return (new_params, new_state, {"table": t_state, "rest": r_state},
                loss.detach())

    return step
