"""Table: an ordered, int-or-str keyed activity container (counterpart of
bigdl_tpu/utils/table.py).

The reference models multi-input and multi-output activities as a
Lua-style ``Table`` (reference utils/Table.scala).  Here, as in the JAX
package, it is a dict subclass keeping the 1-based positional API; the
table layers (:mod:`bigdl_tpu_torch.nn.table_ops`) take one and read its
integer keys in order, then its string keys.
"""
from __future__ import annotations


class Table(dict):
    """Ordered keyed container.  ``Table(a, b, c)`` puts its positional
    arguments under the 1-based keys 1, 2, 3; keyword arguments go under
    their names."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for i, v in enumerate(args):
            self[i + 1] = v
        for k, v in kwargs.items():
            self[k] = v

    def insert(self, value):
        """Append ``value`` at the next free 1-based integer key."""
        i = 1
        while i in self:
            i += 1
        self[i] = value
        return self

    def __repr__(self):
        inner = ", ".join(f"{k!r}: {v!r}" for k, v in self.items())
        return f"Table({{{inner}}})"


def table_keys(t: Table):
    """``t``'s keys in the order the JAX package flattens a Table: the
    integer keys ascending, then the string keys sorted."""
    return sorted(t.keys(), key=lambda k: (isinstance(k, str), k))


def T(*args, **kwargs) -> Table:
    """Shorthand constructor mirroring the reference's ``T()`` helper."""
    return Table(*args, **kwargs)
